"""Training state tree — the unit the OpenCHK directives protect.

``TrainState`` keeps the reference's field names, leaf paths and dtypes
(``step`` int32, ``rng`` uint32[2], ``data_state`` (uint32, int32)), so a
train state checkpointed by either package restores in the other.  The
scalar bookkeeping (``step``, the optimizer's ``count``, ``rng`` and the
data cursor) lives on the host; parameters and moments on their device.

The reference advances ``rng`` with ``jax.random.fold_in(rng, 0)`` every
step.  :func:`fold_in` is threefry-2x32 in numpy on the host, so the bits
are equal.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.train.optimizer import AdamWState, adamw_init


class TrainState(NamedTuple):
    step: torch.Tensor           # scalar int32 — doubles as the checkpoint id
    params: Any
    opt: AdamWState
    rng: torch.Tensor            # uint32[2] threefry key
    data_state: Any              # checkpointable data-pipeline cursor


def init_train_state(params: Any, rng: torch.Tensor, data_state: Any
                     ) -> TrainState:
    return TrainState(
        step=torch.zeros((), dtype=torch.int32),
        params=params,
        opt=adamw_init(params),
        rng=rng,
        data_state=data_state,
    )


# --------------------------------------------------------------------------- #
# threefry-2x32 keys (the reference's jax.random.PRNGKey / fold_in)
# --------------------------------------------------------------------------- #

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of counter words ``(x0, x1)`` under
    ``key`` (two uint32), as ``jax.random``'s default implementation."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.atleast_1d(np.asarray(x0, np.uint32)) + ks[0]
    x1 = np.atleast_1d(np.asarray(x1, np.uint32)) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the reference runs it (64-bit types
    off, so the seed is cut to its low 32 bits): uint32
    ``[0, seed mod 2**32]``."""
    return torch.from_numpy(np.array([0, int(seed) & 0xFFFFFFFF],
                                     dtype=np.uint32))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` on a uint32[2] key, on the host:
    the key hashes the counter ``(0, data)``."""
    k = key.detach().cpu().numpy().astype(np.uint32)
    y0, y1 = threefry2x32(k, 0, int(data) & 0xFFFFFFFF)
    return torch.from_numpy(np.concatenate([y0, y1]).astype(np.uint32))
