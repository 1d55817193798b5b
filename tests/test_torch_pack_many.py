"""One pack per DIFF store: ``ops.pack_dirty_many`` and the grouped
``DiffEngine.compute_deltas`` against the JAX package and per-leaf packing.

On the CPU ``pack_dirty_many`` runs the plain version leaf by leaf; it must
give the rows the reference's ``diffpack_pallas`` (interpret mode) gathers
from each leaf, concatenated, bit for bit.  ``compute_deltas`` packs a
store's dirty leaves by groups; its payloads and the DIFF container it
writes must equal those of packing each leaf on its own.  The batched
Hopper kernel is checked on a card in ``tests/test_torch_gpu.py``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.diffpack import diffpack_pallas
from repro_torch.core import diff
from repro_torch.core.context import (CHK_DIFF, CheckpointConfig,
                                      CheckpointContext)
from repro_torch.core.formats import numpy_to_tensor
from repro_torch.core.protect import from_numpy_named
from repro_torch.kernels import ops


def _leaves(rng):
    """Mixed dtypes, a ragged last block, a 0-byte leaf."""
    return [(rng.randn(777) * 10).astype(np.float32),
            (rng.randn(301) * 10).astype(ml_dtypes.bfloat16),
            rng.randint(0, 256, 1001).astype(np.uint8),
            (rng.randn(100) * 10).astype(np.float64),
            np.zeros((0,), np.float32),
            (rng.randn(5, 70) * 10).astype(np.int8)]


@pytest.mark.parametrize("block_bytes", [256, 1024])
def test_pack_dirty_many_matches_pallas_leaf_by_leaf(block_bytes):
    """Bit for bit against diffpack_pallas (interpret mode) per leaf,
    concatenated in order; a leaf with no dirty block adds no row, a 0-byte
    leaf's block 0 is a zero row."""
    rng = np.random.RandomState(block_bytes)
    arrays = _leaves(rng)
    dirty = []
    for i, a in enumerate(arrays):
        n = max(1, -(-a.nbytes // block_bytes))
        if i == 3:
            dirty.append(np.zeros(0, np.int32))          # nothing dirty
        else:
            pick = rng.choice(n, size=min(n, 3), replace=False)
            dirty.append(np.unique(np.append(pick, n - 1)).astype(np.int32))
    want = []
    with jax.enable_x64(True):
        for a, idx in zip(arrays, dirty):
            if idx.size:
                blocks, _ = jops.as_u32_blocks(jnp.asarray(a), block_bytes)
                want.append(np.asarray(diffpack_pallas(
                    blocks, jnp.asarray(idx), interpret=True)))
    got = ops.pack_dirty_many([numpy_to_tensor(a) for a in arrays], dirty,
                              block_bytes)
    assert got.dtype == torch.int32
    assert np.array_equal(ops.u32_numpy(got), np.concatenate(want))
    # and the same rows as one leaf at a time
    per_leaf = [ops.u32_numpy(ops.pack_dirty_many([numpy_to_tensor(a)], [i],
                                                  block_bytes))
                for a, i in zip(arrays, dirty)]
    assert np.array_equal(ops.u32_numpy(got), np.concatenate(per_leaf))
    assert ops.launch_counts()["diffpack"] == 0       # the plain version


def test_pack_dirty_many_checks_like_pack_dirty():
    x = torch.arange(100, dtype=torch.float32)        # 2 blocks of 256 B
    with pytest.raises(IndexError, match="outside"):
        ops.pack_dirty_many([x, x], [np.array([0]), np.array([2])], 256)
    with pytest.raises(IndexError, match="outside"):
        ops.pack_dirty_many([x], [np.array([-1])], 256)
    with pytest.raises(ValueError, match="one index array per leaf"):
        ops.pack_dirty_many([x, x], [np.array([0])], 256)
    with pytest.raises(ValueError, match="at least one leaf"):
        ops.pack_dirty_many([], [], 256)


def _per_leaf_pack(self, pending):
    """DiffEngine._pack_dirty as it was: one pack and one D2H per leaf."""
    return {path: ops.u32_numpy(ops.pack_dirty_many([leaf], [dirty],
                                                    self.block_bytes))
            for path, leaf, _h, dirty in pending if dirty.size}


def _state(rng):
    return {"a": rng.randn(40, 33).astype(np.float32),
            "b": (rng.randn(513) * 10).astype(ml_dtypes.bfloat16),
            "c": rng.randint(0, 9, 3).astype(np.int64),
            "d": rng.randn(7).astype(np.float32)}


def _touch(st, rng):
    out = {k: v.copy() for k, v in st.items()}
    out["a"][rng.randint(0, 40, 9)] += 1.0
    out["b"][-3:] = 2.5
    out["c"][0] += 1                                 # "d" stays clean
    return out


@pytest.mark.parametrize("cap_blocks", [1, 3, 1000])
def test_compute_deltas_groups_equal_per_leaf_packing(monkeypatch,
                                                      cap_blocks):
    """Groups of at most MAX_PACK_BYTES of rows (a leaf's rows split across
    groups when the cap is small): one pack per group, and each payload
    equal to per-leaf packing, C-contiguous uint32."""
    bb = 256
    monkeypatch.setattr(diff, "MAX_PACK_BYTES", cap_blocks * bb)
    rng = np.random.RandomState(4)
    s0 = _state(rng)
    s1 = _touch(s0, rng)
    calls = []
    real = ops.pack_dirty_many

    def spy(leaves, dirty_list, block_bytes):
        calls.append(sum(int(np.asarray(i).size) for i in dirty_list))
        return real(leaves, dirty_list, block_bytes)

    monkeypatch.setattr(ops, "pack_dirty_many", spy)
    eng, ref_eng = diff.DiffEngine(bb), diff.DiffEngine(bb)
    monkeypatch.setattr(ref_eng, "_pack_dirty",
                        _per_leaf_pack.__get__(ref_eng))
    for e in (eng, ref_eng):
        e.update_digests_full(from_numpy_named(s0))
    got, stats = eng.compute_deltas(from_numpy_named(s1))
    n_calls = len(calls)
    want, want_stats = ref_eng.compute_deltas(from_numpy_named(s1))
    assert stats.dirty_blocks == want_stats.dirty_blocks > 0
    assert stats.bytes_written == want_stats.bytes_written
    assert calls[:n_calls] and max(calls[:n_calls]) <= cap_blocks
    assert n_calls == -(-stats.dirty_blocks // cap_blocks)
    for g, w in zip(got, want):
        assert g.path == w.path and np.array_equal(g.dirty_idx, w.dirty_idx)
        assert g.payload.dtype == np.uint32 and g.payload.flags.c_contiguous
        assert np.array_equal(g.payload, w.payload)
    assert [d.payload.shape[0] for d in got if d.path == "d"] == [0]


def test_diff_container_byte_identical_to_per_leaf_packing(tmp_path,
                                                           monkeypatch):
    """FULL then DIFF through the directives, once with the grouped pack
    and once packing leaf by leaf: the DIFF containers are the same
    bytes."""
    rng = np.random.RandomState(5)
    s0 = _state(rng)
    s1 = _touch(s0, rng)

    def run(name):
        cfg = CheckpointConfig(dir=str(tmp_path / name), backend="fti",
                               block_bytes=256, objstore=False)
        ctx = CheckpointContext(cfg)
        ctx.store(from_numpy_named(s0), id=1, level=1)
        ctx.store(from_numpy_named(s1), id=2, level=1, kind=CHK_DIFF)
        ctx.shutdown()
        found = sorted(Path(tmp_path / name).rglob("ckpt-2/*.chk5"))
        assert len(found) == 1
        return found[0].read_bytes()

    grouped = run("grouped")
    monkeypatch.setattr(diff.DiffEngine, "_pack_dirty", _per_leaf_pack)
    assert run("per-leaf") == grouped
