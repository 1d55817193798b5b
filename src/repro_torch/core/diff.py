"""Differential checkpointing engine (paper §4.2.3, FTI dCP semantics).

Per protected leaf, a 64-bit digest per ``block_bytes`` block is kept from
the previous checkpoint.  On a CHK_DIFF store the new digests are computed
on the leaf's device (the blockhash kernel on the card; its plain PyTorch
version on the CPU), the dirty map is diffed on the host (tiny), dirty
blocks are compacted on the device by the diffpack kernel and only those
cross to the host.

No clean-leaf skip.  The JAX package skips hashing a leaf that is the same
object as at the previous store, which is sound only because jax arrays
are immutable.  Torch tensors are updated in place (``add_``, optimizer
steps), and ``Tensor._version`` misses writes made through ``.data`` or
through another tensor sharing the storage — so here every DIFF and FULL
leaf is hashed, every time, and ``DiffStats.skipped_leaves`` stays 0.  On
an H100 that costs one pass over the state at HBM speed (the bound is
about 1.3 ms for 4.4 GB).

All digest-state mutation happens in the pipeline's Plan stage, on the
calling thread in submission order (a failed tail only invalidates) —
which is what lets DIFF stores run on a CP-dedicated thread without
racing the digest chain.

Break-even guard: the paper measures differential checkpointing to pay off
below a ~95 % dirty ratio (Fig. 7).  When the observed ratio exceeds
``promote_threshold`` the engine *promotes* the store to a FULL checkpoint.

Restore: FULL base + ordered DIFF deltas are replayed into flat uint32
buffers on the host with numpy, then bit-cast back to the leaf dtype/shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import numpy_to_tensor
from repro_torch.core.formats import str_to_dtype as str_dtype
from repro_torch.core.protect import leaf_dtype_str
from repro_torch.kernels import ops


@dataclass
class LeafDelta:
    path: str
    dtype: str
    shape: List[int]
    n_blocks: int
    dirty_idx: np.ndarray        # (n_dirty,) int32
    payload: np.ndarray          # (n_dirty, block_elems) uint32
    digests: np.ndarray          # (n_blocks, 2) uint32 — post-store state


@dataclass
class DiffStats:
    total_blocks: int = 0
    dirty_blocks: int = 0
    bytes_written: int = 0
    skipped_leaves: int = 0      # always 0 here: every leaf is hashed
    promoted_full: bool = False

    @property
    def dirty_ratio(self) -> float:
        return self.dirty_blocks / max(1, self.total_blocks)


def as_tensor(leaf: Any) -> torch.Tensor:
    """A protected leaf as a tensor (numpy and scalar leaves → CPU)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return numpy_to_tensor(np.asarray(leaf))


class DiffEngine:
    def __init__(self, block_bytes: int = ops.DEFAULT_BLOCK_BYTES,
                 promote_threshold: float = 0.95):
        self.block_bytes = block_bytes
        self.promote_threshold = promote_threshold
        self._digests: Dict[str, np.ndarray] = {}
        self.epoch = 0       # bumped on invalidate(); DIFF plans check it

    # ------------------------------------------------------------------ #

    def invalidate(self, paths) -> None:
        """Drop digest state for ``paths`` (a store of them failed after the
        chain advanced).  Conservative and safe: the next DIFF sees no base
        for these leaves, marks every block dirty, and the promote guard
        turns that into a FULL — never a delta against phantom data."""
        paths = list(paths)
        for p in paths:
            self._digests.pop(p, None)
        if paths:
            self.epoch += 1

    def launch_digests(self, named: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Hash every leaf on its device → ``{path: (n_blocks, 2) tensor}``.
        On the card this only enqueues the kernels on the current stream:
        work queued after it on that stream (a D2H snapshot, or the
        caller's next in-place update) runs after the hash has read the
        bytes."""
        return {path: ops.blockhash(as_tensor(leaf), self.block_bytes)
                for path, leaf in named.items()}

    def commit_digests(self, digests: Dict[str, torch.Tensor]) -> None:
        """Copy launched digests to the host and make them the DIFF base."""
        for path, d in digests.items():
            self._digests[path] = ops.u32_numpy(d)

    def update_digests_full(self, named: Dict[str, Any]) -> None:
        """After a FULL store: record digests so the next DIFF has a base."""
        self.commit_digests(self.launch_digests(named))

    def compute_deltas(self, named: Dict[str, Any]
                       ) -> Tuple[Optional[List[LeafDelta]], DiffStats]:
        """→ (deltas, stats); deltas=None means "promote to FULL".  The
        packed dirty blocks are host copies, complete when this returns."""
        stats = DiffStats()
        pending: List[Tuple[str, torch.Tensor, np.ndarray, np.ndarray]] = []
        for path, d in self.launch_digests(named).items():
            h_new = ops.u32_numpy(d)
            dirty = ops.dirty_indices(h_new, self._digests.get(path))
            stats.total_blocks += h_new.shape[0]
            stats.dirty_blocks += int(dirty.shape[0])
            pending.append((path, as_tensor(named[path]), h_new, dirty))

        if stats.dirty_ratio > self.promote_threshold:
            stats.promoted_full = True
            # the promoted FULL store persists exactly these leaves — commit
            # the already-computed digests so the caller need not re-hash
            for path, _leaf, h_new, _dirty in pending:
                self._digests[path] = h_new
            return None, stats

        deltas = []
        for path, leaf, h_new, dirty in pending:
            if dirty.shape[0] == 0:
                payload = np.zeros((0, self.block_bytes // 4), np.uint32)
            else:
                payload = ops.u32_numpy(
                    ops.pack_dirty(leaf, dirty, self.block_bytes))
            stats.bytes_written += payload.nbytes
            deltas.append(LeafDelta(
                path=path,
                dtype=leaf_dtype_str(leaf),
                shape=list(leaf.shape),
                n_blocks=int(h_new.shape[0]),
                dirty_idx=dirty,
                payload=payload,
                digests=h_new,
            ))
        for d in deltas:
            self._digests[d.path] = d.digests
        return deltas, stats


# -------------------------------------------------------------------------- #
# restore-side replay (host, numpy — as in the JAX package)
# -------------------------------------------------------------------------- #


def leaf_to_u32_flat(arr: np.ndarray, block_bytes: int) -> np.ndarray:
    be = block_bytes // 4
    raw = np.ascontiguousarray(arr).tobytes()
    pad = (-len(raw)) % 4
    buf = np.frombuffer(raw + b"\x00" * pad, np.uint32)
    n_blocks = max(1, -(-buf.shape[0] // be))
    out = np.zeros(n_blocks * be, np.uint32)
    out[: buf.shape[0]] = buf
    return out


def u32_flat_to_leaf(buf: np.ndarray, dtype: str, shape: List[int]
                     ) -> np.ndarray:
    dt = str_dtype(dtype)
    n_bytes = int(np.prod(shape)) * dt.itemsize
    return np.frombuffer(buf.tobytes()[:n_bytes], dtype=dt).reshape(shape).copy()


def apply_delta(buf: np.ndarray, dirty_idx: np.ndarray, payload: np.ndarray,
                block_bytes: int) -> np.ndarray:
    be = block_bytes // 4
    blocks = buf.reshape(-1, be)
    if dirty_idx.shape[0]:
        blocks[dirty_idx] = payload
    return blocks.reshape(-1)
