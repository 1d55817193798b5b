"""Deterministic synthetic data with a checkpointable cursor.

The cursor (:class:`DataState`) is part of ``TrainState``, so a checkpoint
captures the exact position in the stream: after a restart, training
consumes the *same* batches it would have seen without the fault
(exactly-once data semantics), as in ``repro.data.synthetic``.

Its leaves keep the reference's names and dtypes (``seed`` uint32,
``position`` int32, both scalars), so a cursor checkpointed by either
package restores in the other.  The batches differ from the reference's:
they come from a ``torch.Generator`` seeded from ``(seed, position)``,
where the reference folds the position into a threefry key.  They are
drawn on the host, so a batch is the same whichever device it goes to.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig


class DataState(NamedTuple):
    seed: torch.Tensor            # scalar uint32
    position: torch.Tensor        # scalar int32 — batches consumed


def init_data_state(seed: int = 0) -> DataState:
    return DataState(torch.tensor(seed, dtype=torch.uint32),
                     torch.zeros((), dtype=torch.int32))


def next_batch(
    state: DataState,
    cfg: ArchConfig,
    global_batch: int,
    seq_len: int,
    device=None,
) -> Tuple[Dict[str, torch.Tensor], DataState]:
    """Cursor → (batch on ``device``, cursor+1).  Pure: the same cursor
    gives the same batch."""
    seed = int(state.seed) & 0xFFFFFFFF
    gen = torch.Generator().manual_seed(
        (seed << 32) | (int(state.position) & 0xFFFFFFFF))
    out: Dict[str, torch.Tensor] = {}
    if cfg.encdec:
        out["frames"] = (torch.randn(
            (global_batch, seq_len, cfg.d_model), generator=gen) * 0.02).to(
            getattr(torch, cfg.compute_dtype))
        toks = torch.randint(0, cfg.vocab_size, (global_batch, seq_len + 1),
                             generator=gen, dtype=torch.int32)
        out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
    elif cfg.frontend == "vision_stub":
        p = cfg.n_frontend_tokens
        out["patch_embeds"] = (torch.randn(
            (global_batch, p, cfg.d_model), generator=gen) * 0.02).to(
            getattr(torch, cfg.compute_dtype))
        toks = torch.randint(0, cfg.vocab_size,
                             (global_batch, seq_len - p + 1), generator=gen,
                             dtype=torch.int32)
        out["tokens"] = toks[:, :-1]
        # labels cover the full (patch+text) sequence; patch positions ignored
        pad = torch.full((global_batch, p), -1, dtype=torch.int32)
        out["labels"] = torch.cat([pad, toks[:, 1:]], dim=1)
    else:
        toks = torch.randint(0, cfg.vocab_size, (global_batch, seq_len + 1),
                             generator=gen, dtype=torch.int32)
        out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
    device = torch.device("cpu") if device is None else device
    out = {k: v.contiguous().to(device) for k, v in out.items()}
    return out, DataState(state.seed, state.position + 1)


class SyntheticDataset:
    """Host-side iterator over :func:`next_batch` whose cursor can be
    checkpointed (``get_state`` / ``set_state``); batches go to
    ``device``."""

    def __init__(self, cfg: ArchConfig, global_batch: int, seq_len: int,
                 seed: int = 0, device=None):
        self.cfg, self.gb, self.sl = cfg, global_batch, seq_len
        self.device = device
        self.state = init_data_state(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch, self.state = next_batch(self.state, self.cfg, self.gb,
                                       self.sl, self.device)
        return batch

    # checkpointable cursor ------------------------------------------------ #
    def get_state(self) -> DataState:
        return self.state

    def set_state(self, st: DataState) -> None:
        self.state = st
