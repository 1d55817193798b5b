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

from repro_torch.train.optimizer import AdamWState, adamw_init, tree_map


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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_state_struct(param_struct: Any, data_state_struct: Any
                       ) -> TrainState:
    """The ``TrainState`` of ``param_struct`` (``Model.param_struct()``) as
    ``meta`` tensors: the dry-run's and the sharding rules' input."""
    def moment(p):
        return _meta(p.shape, torch.float32)

    return TrainState(
        step=_meta((), torch.int32),
        params=param_struct,
        opt=AdamWState(_meta((), torch.int32), tree_map(moment, param_struct),
                       tree_map(moment, param_struct)),
        rng=_meta((2,), torch.uint32),
        data_state=data_state_struct,
    )


def init_sharded_train_state(params: Any, shardings: "TrainState",
                             rng: torch.Tensor, data_state: Any
                             ) -> TrainState:
    """A ``TrainState`` laid out by ``shardings`` (a ``TrainState`` of
    ``NamedSharding``: ``dist.sharding.train_state_shardings``): ``params``
    (the global values, the same on every rank, or ``DTensor`` leaves) are
    placed by ``shardings.params``, the zero moments are made in
    ``shardings.opt.mu``'s layout, each rank allocating its own box only;
    ``step``, ``count``, ``rng`` and the data cursor stay on the host."""
    from repro_torch.core.resharding import reshard_tree, zeros_onto

    params = reshard_tree(params, shardings.params)
    f32 = tree_map(lambda p: _meta(p.shape, torch.float32), params)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32),
        params=params,
        opt=AdamWState(torch.zeros((), dtype=torch.int32),
                       zeros_onto(f32, shardings.opt.mu),
                       zeros_onto(f32, shardings.opt.nu)),
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
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():      # host values, even inside a trace
        k = key.detach().cpu().numpy().astype(np.uint32)
        y0, y1 = threefry2x32(k, 0, int(data) & 0xFFFFFFFF)
        return torch.from_numpy(np.concatenate([y0, y1]).astype(np.uint32))
