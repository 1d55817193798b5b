"""The port's differential checkpointing engine and state flattening
against the JAX package, on the CPU, bit for bit.

Both engines see the same state sequence (made with numpy from a seed) and
must produce the same dirty blocks, payload bytes and digests.  One
difference is by design: the JAX engine skips hashing a leaf that is the
same array object as at the previous store (jax arrays are immutable); the
port hashes every leaf every time, because a torch tensor can change in
place without becoming a new object, so its ``skipped_leaves`` is 0.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import diff as jdiff
from repro.core import protect as jprotect
from repro_torch.core import diff
from repro_torch.core.formats import numpy_to_tensor
from repro_torch.core.protect import (
    flatten_named,
    from_numpy_named,
    to_host,
    unflatten_named,
)

BB = 256


def _states(seed, n_steps=4):
    """A seeded sequence of {path: array} states with sparse edits."""
    rng = np.random.RandomState(seed)
    cur = {"a": (rng.randn(3000) * 10).astype(np.float32),
           "b": rng.randint(-9, 9, size=(17, 33)).astype(np.int32),
           "c": (rng.randn(501) * 3).astype(ml_dtypes.bfloat16),
           "d": rng.randint(0, 255, size=999).astype(np.uint8)}
    out = [{k: v.copy() for k, v in cur.items()}]
    for _ in range(n_steps):
        for k, v in cur.items():
            flat = v.reshape(-1)
            for i in rng.randint(0, flat.size, size=rng.randint(0, 6)):
                flat[i] = flat[i] + np.asarray(1, dtype=v.dtype)
        out.append({k: v.copy() for k, v in cur.items()})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_deltas_matches_reference(seed):
    states = _states(seed)
    jeng = jdiff.DiffEngine(block_bytes=BB)
    eng = diff.DiffEngine(block_bytes=BB)
    jeng.update_digests_full({k: jnp.asarray(v) for k, v in states[0].items()})
    eng.update_digests_full(from_numpy_named(states[0]))
    for st in states[1:]:
        jd, js = jeng.compute_deltas({k: jnp.asarray(v) for k, v in st.items()})
        d, s = eng.compute_deltas(from_numpy_named(st))
        assert (s.total_blocks, s.dirty_blocks, s.bytes_written) == \
            (js.total_blocks, js.dirty_blocks, js.bytes_written)
        assert s.promoted_full == js.promoted_full
        assert [x.path for x in d] == [x.path for x in jd]
        for x, jx in zip(d, jd):
            assert (x.dtype, x.shape, x.n_blocks) == \
                (jx.dtype, jx.shape, jx.n_blocks)
            assert np.array_equal(x.dirty_idx, jx.dirty_idx)
            assert x.payload.dtype == jx.payload.dtype == np.uint32
            assert np.array_equal(x.payload, np.asarray(jx.payload))
            assert np.array_equal(x.digests, np.asarray(jx.digests))


def test_every_leaf_is_hashed_even_when_unchanged_or_same_object(monkeypatch):
    """skipped_leaves is 0 on the port: an in-place update keeps the tensor
    object (and a write through ``.data`` even keeps ``_version``), so an
    identity shortcut would miss it.  The JAX engine skips the same-object
    leaf, which is sound only for immutable arrays."""
    calls = []
    real = diff.ops.blockhash
    monkeypatch.setattr(diff.ops, "blockhash",
                        lambda leaf, bb: calls.append(1) or real(leaf, bb))
    eng = diff.DiffEngine(block_bytes=BB)
    x = torch.arange(1024, dtype=torch.float32)
    eng.update_digests_full({"x": x})
    deltas, stats = eng.compute_deltas({"x": x})
    assert stats.skipped_leaves == 0 and stats.dirty_blocks == 0
    version = x._version
    x.data[700] = -1.0                       # invisible to _version
    assert x._version == version
    deltas, stats = eng.compute_deltas({"x": x})
    assert len(calls) == 3 and stats.skipped_leaves == 0
    assert deltas[0].dirty_idx.tolist() == [700 * 4 // BB]

    jeng = jdiff.DiffEngine(block_bytes=BB)
    jx = jnp.arange(1024, dtype=jnp.float32)
    jeng.update_digests_full({"x": jx})
    _, jstats = jeng.compute_deltas({"x": jx})
    assert jstats.skipped_leaves == 1


def test_first_diff_promotes_and_threshold():
    eng = diff.DiffEngine(block_bytes=BB, promote_threshold=0.5)
    a = torch.arange(1024, dtype=torch.float32)
    deltas, stats = eng.compute_deltas({"a": a})
    assert deltas is None and stats.promoted_full and stats.dirty_ratio == 1.0
    deltas, stats = eng.compute_deltas({"a": a + 1.0})
    assert deltas is None and stats.promoted_full
    deltas, stats = eng.compute_deltas({"a": a + 1.0})
    assert deltas is not None and stats.dirty_blocks == 0


@pytest.mark.parametrize("dtype", ["float32", "int32", "float16", "uint8",
                                   "bfloat16"])
def test_replay_matches_reference(dtype):
    """FULL base + delta chain replays to the exact final array, and the
    flat u32 buffers equal the JAX package's at every step."""
    dt = np.dtype(getattr(ml_dtypes, dtype, dtype))
    rng = np.random.RandomState(5)
    n = 1777
    cur = np.abs(rng.randn(n) * 10).astype(dt)
    eng = diff.DiffEngine(block_bytes=BB)
    eng.update_digests_full({"x": numpy_to_tensor(cur)})
    buf = diff.leaf_to_u32_flat(cur, BB)
    assert np.array_equal(buf, jdiff.leaf_to_u32_flat(cur, BB))
    for _ in range(3):
        for i in rng.randint(0, n, size=9):
            cur[i] = np.asarray(abs(rng.randn()) * 10).astype(dt)
        deltas, _ = eng.compute_deltas({"x": numpy_to_tensor(cur)})
        d = deltas[0]
        jbuf = jdiff.apply_delta(buf.copy(), d.dirty_idx, d.payload, BB)
        buf = diff.apply_delta(buf, d.dirty_idx, d.payload, BB)
        assert np.array_equal(buf, jbuf)
    got = diff.u32_flat_to_leaf(buf, d.dtype, [n])
    assert got.dtype == dt and got.tobytes() == cur.tobytes()


def test_flatten_named_order_and_paths_match_reference():
    """jax sorts dict keys; torch's pytree keeps insertion order — the port
    must give the reference's paths and leaf order."""
    def tree(mk):
        return {"b": mk(1), "a": {"y": mk(2), "x": mk(3)},
                "layers": [{"w.q": mk(4), ".hidden": mk(5)}, (mk(6), mk(7))],
                "it's": mk(8), "n": None, "ids": {10: mk(9), 2: mk(10)}}

    jnamed, _ = jprotect.flatten_named(tree(np.float32))
    t = tree(lambda v: torch.tensor(float(v)))
    named = flatten_named(t)
    assert list(named) == list(jnamed)
    assert list(named)[:3] == ["a/x", "a/y", "b"]
    assert [float(v) for v in named.values()] == \
        [float(v) for v in jnamed.values()]
    back = unflatten_named(named, t)
    assert list(back) == list(t) and back["n"] is None
    assert isinstance(back["layers"][1], tuple)
    assert float(back["layers"][1][1]) == 7.0
    with pytest.raises(TypeError):          # mixed key types: jax refuses too
        flatten_named({"a": torch.zeros(1), 3: torch.zeros(1)})


def test_numpy_bridge_keeps_bytes_and_never_aliases():
    rng = np.random.RandomState(0)
    named_np = {"f": rng.randn(5, 3).astype(np.float32),
                "h": rng.randn(9).astype(ml_dtypes.bfloat16),
                "i": np.asarray(np.int32(7)),
                "u": rng.randint(0, 255, 11).astype(np.uint8),
                "d": rng.randn(4).astype(np.float64)}
    named = from_numpy_named(named_np)
    assert named["h"].dtype == torch.bfloat16 and named["i"].shape == ()
    host = to_host(named)
    for k, a in named_np.items():
        assert host[k].dtype == a.dtype and host[k].shape == a.shape
        assert host[k].tobytes() == a.tobytes()
    named["f"][0, 0] = 123.0                 # no aliasing either way
    assert named_np["f"][0, 0] != 123.0 and host["f"][0, 0] != 123.0
