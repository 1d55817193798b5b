"""DIFF replay on the restart template's device, on the CPU.

``ops.unpack_dirty_many`` on one leaf (the diffunpack kernel's entry
point; its plain version here) against the JAX package's Pallas scatter in
interpret mode and the numpy replay, with its index checks and its refusal
of a target it cannot write in place.  Then the restore itself: a
checkpoint chain restored into a template of CPU tensors (the leaves
replay through ``unpack_dirty_many``, one call per DIFF link) equals, byte for byte, the port's numpy replay and the
JAX package's own restore — over every case a restore meets: a plain DIFF
chain, a mixed-kind container, a FULL dataset that supersedes an older
delta, a DIFF whose base was stored with ``compress="int8"`` or
``precision="bf16"``, and ragged last blocks (sub-word tails, a 0-byte
leaf).  Inputs are numpy arrays from a seed, handed to both packages.
"""
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import context as jctx
from repro.core import diff as jdiff
from repro.kernels.diffpack import diffunpack_pallas
from repro_torch.core.context import (
    CHK_DIFF,
    CHK_FULL,
    CheckpointConfig,
    CheckpointContext,
    Protect,
)
from repro_torch.core import diff as tdiff
from repro_torch.core.diff import (
    ChainReplay,
    apply_delta,
    leaf_to_u32_flat,
    u32_flat_to_leaf,
)
from repro_torch.core.formats import dtype_to_str, numpy_to_tensor, tensor_to_numpy
from repro_torch.core.protect import flatten_named, from_numpy_named, unflatten_named
from repro_torch.kernels import ops

BB = 256


# --------------------------------------------------------------------------- #
# ops.unpack_dirty_many on one leaf
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.uint8,
                                   np.float64, np.int16],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n", [0, 1, 63, 1001])
def test_unpack_dirty_equals_numpy_replay(dtype, n):
    """Every dtype width, ragged tails: the leaf after the scatter equals
    the numpy replay (apply_delta on the padded flat buffer, then cut back
    to the leaf), including the last, partial block."""
    rng = np.random.RandomState(n)
    a = (rng.randn(n) * 100).astype(dtype)
    new = (rng.randn(n) * 100).astype(dtype)
    n_blocks = max(1, -(-a.nbytes // BB))
    idx = np.unique(np.array([0, n_blocks - 1, n_blocks // 2], np.int32))
    packed = leaf_to_u32_flat(new, BB).reshape(-1, BB // 4)[idx]
    want = u32_flat_to_leaf(apply_delta(leaf_to_u32_flat(a, BB), idx,
                                        packed, BB),
                            dtype_to_str(a.dtype), list(a.shape))
    t = numpy_to_tensor(a)
    out = ops.unpack_dirty_many([t], [idx], [packed], BB)
    assert out[0] is t
    assert tensor_to_numpy(t).tobytes() == want.tobytes()
    if n and idx.size == n_blocks:                 # every block replaced
        assert tensor_to_numpy(t).tobytes() == new.tobytes()


def test_unpack_dirty_matches_pallas_scatter():
    """On whole blocks the scatter is the Pallas kernel's, bit for bit."""
    rng = np.random.RandomState(3)
    base = rng.randint(0, 2**32, size=(16, BB // 4), dtype=np.uint64
                       ).astype(np.uint32)
    packed = rng.randint(0, 2**32, size=(5, BB // 4), dtype=np.uint64
                         ).astype(np.uint32)
    idx = np.array([0, 2, 7, 8, 15], np.int32)
    t = numpy_to_tensor(base.copy())
    ops.unpack_dirty_many([t], [idx], [packed], BB)
    want = np.asarray(diffunpack_pallas(jnp.asarray(base),
                                        jnp.asarray(packed),
                                        jnp.asarray(idx), interpret=True))
    assert np.array_equal(tensor_to_numpy(t), want)
    # int32-bit rows on the tensor side take the same path
    t2 = numpy_to_tensor(base.copy())
    ops.unpack_dirty_many([t2], [idx], [torch.from_numpy(packed.view(np.int32))],
                          BB)
    assert torch.equal(t2, t)


def test_unpack_dirty_checks_indices_and_refuses_non_contiguous():
    x = torch.arange(1000, dtype=torch.float32)        # 16 blocks of 256 B
    rows = np.zeros((2, BB // 4), np.uint32)
    def unpack(t, idx, r):
        return ops.unpack_dirty_many([t], [np.array(idx, np.int32)], [r], BB)

    with pytest.raises(IndexError, match="outside"):
        unpack(x, [3, 16], rows)
    with pytest.raises(IndexError, match="outside"):
        unpack(x, [-1, 3], rows)
    with pytest.raises(ValueError, match="increase strictly"):
        unpack(x, [4, 4], rows)
    with pytest.raises(ValueError, match="increase strictly"):
        unpack(x, [5, 4], rows)
    with pytest.raises(ValueError, match="packed rows"):
        unpack(x, [1, 2, 3], rows)
    with pytest.raises(ValueError, match="contiguous"):
        unpack(x.reshape(40, 25).t(), [1, 2], rows)
    assert torch.equal(x, torch.arange(1000, dtype=torch.float32))
    # a 0-byte leaf has one (padded) block: index 0 is taken, nothing written
    e = torch.zeros(0)
    unpack(e, [0], np.ones((1, BB // 4), np.uint32))
    assert e.numel() == 0
    assert ops.launch_counts()["diffunpack"] == 0      # CPU: plain version


def test_unpack_dirty_writes_through_a_view_with_an_offset():
    """A contiguous view with a storage offset is written in place: the
    bytes outside the view stay untouched."""
    buf = torch.zeros(1100, dtype=torch.float32)
    view = buf[100:]                                   # 1,000 floats
    new = torch.arange(1000, dtype=torch.float32) + 1
    idx = np.arange(16, dtype=np.int32)
    rows = ops.pack_dirty_many([new], [idx], BB)
    ops.unpack_dirty_many([view], [idx], [rows], BB)
    assert torch.equal(view, new) and not bool(buf[:100].any())


# --------------------------------------------------------------------------- #
# the restore: a tensor template replays on its device
# --------------------------------------------------------------------------- #

def _state(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"w": rng.randn(300, 7).astype(np.float32),   # ragged
                       "b": rng.randn(51).astype(ml_dtypes.bfloat16),
                       "u": rng.randint(0, 256, 1001).astype(np.uint8),
                       "e": np.zeros((0,), np.float32)},
            "step": np.asarray(np.int32(seed))}


def _edit(st, i):
    """A sparse update touching the ragged last block of each leaf."""
    rng = np.random.RandomState(100 + i)
    p = {k: v.copy() for k, v in st["params"].items()}
    for j in rng.randint(0, p["w"].size, size=3):
        p["w"].reshape(-1)[j] += 1.0
    p["w"].reshape(-1)[-1] -= 2.0
    p["b"][-1] += 1
    p["u"][-1] ^= 0x5A
    p["u"][rng.randint(0, 1001)] ^= 0xFF
    return {"params": p, "step": np.asarray(np.int32(int(st["step"]) + 1))}


_ALL = ("params/w", "params/b", "params/u", "params/e", "step")


def _specs(P, case, i):
    """The Protect clauses of store ``i`` of ``case`` (None: all leaves)."""
    if case == "mixed" and i == 1:
        return [P("params/**", kind=CHK_DIFF), P("step")]
    if case == "superseded" and i == 2:           # w FULL, the rest DIFF
        return [P("params/w", kind=CHK_FULL)] + [P(p) for p in _ALL[1:]]
    if case in ("int8", "bf16"):
        clause = ({"compress": "int8"} if case == "int8"
                  else {"precision": "bf16"})
        return [P("params/w", **clause)] + [P(p) for p in _ALL[1:]]
    return None


#: (ckpt_id, store-level kind) per store
_STORES = {
    "chain": [(1, CHK_FULL), (2, CHK_DIFF), (3, CHK_DIFF)],
    "mixed": [(1, CHK_FULL), (2, CHK_FULL)],
    "superseded": [(1, CHK_FULL), (2, CHK_DIFF), (3, CHK_DIFF),
                   (4, CHK_DIFF)],
    "int8": [(1, CHK_FULL), (2, CHK_DIFF)],
    "bf16": [(1, CHK_FULL), (2, CHK_DIFF)],
}


def _write(pkg, d, case):
    st = _state(0)
    if pkg == "jax":
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
            dir=d, backend="fti", block_bytes=BB, objstore=False,
            dedicated_thread=False))
        P = jctx.Protect

        def conv(s):
            return {"params": {k: jnp.asarray(v)
                               for k, v in s["params"].items()},
                    "step": jnp.asarray(s["step"])}
    else:
        ctx = CheckpointContext(CheckpointConfig(
            dir=d, backend="fti", block_bytes=BB, objstore=False,
            dedicated_thread=False))
        P = Protect

        def conv(s):
            return unflatten_named(from_numpy_named(flatten_named(s)), s)
    kinds = []
    for i, (ckpt_id, kind) in enumerate(_STORES[case]):
        if i:
            st = _edit(st, i)
        ctx.protect(*(_specs(P, case, i) or []))
        rep = ctx.store(conv(st), id=ckpt_id, level=1, kind=kind)
        kinds.append(rep.kind)
    ctx.shutdown()
    return st, kinds


def _zeros():
    z = _state(0)
    return {"params": {k: np.zeros_like(v) for k, v in z["params"].items()},
            "step": np.zeros((), np.int32)}


def _restore_jax(d):
    ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
        dir=d, backend="fti", objstore=False))
    z = _zeros()
    got = ctx.load({"params": {k: jnp.asarray(v)
                               for k, v in z["params"].items()},
                    "step": jnp.asarray(z["step"])})
    assert ctx.restarted
    ctx.shutdown()
    return {k: np.asarray(v) for k, v in flatten_named(
        {"params": dict(got["params"]), "step": got["step"]}).items()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", list(_STORES))
def test_tensor_template_replay_equals_numpy_replay(tmp_path, monkeypatch,
                                                    writer, case):
    d = str(tmp_path / "ck")
    final, kinds = _write(writer, d, case)
    assert kinds[-1] == CHK_DIFF                  # the newest link is a delta
    if case in ("int8", "bf16"):
        assert kinds[0] == CHK_FULL

    # the port's numpy replay (no devices: the JAX package's path)
    probe = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
    host, meta = probe.tcl.backend.engine.load_latest()
    probe.shutdown()
    assert meta["kind"] == CHK_DIFF

    # the replay on the template's device, counted
    calls = []
    real = ops.unpack_dirty_many

    def spy(leaves, idxs, blocks, bb):
        calls.append(sum(i.size for i in idxs))
        return real(leaves, idxs, blocks, bb)

    monkeypatch.setattr(ops, "unpack_dirty_many", spy)
    ctx = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
    z = _zeros()
    got = ctx.load(unflatten_named(from_numpy_named(flatten_named(z)), z))
    ctx.shutdown()
    assert ctx.restarted and calls, "no leaf replayed on its device"
    on_dev = {k: tensor_to_numpy(v) for k, v in flatten_named(got).items()}
    assert all(isinstance(v, torch.Tensor) for v in
               flatten_named(got).values())

    ref = _restore_jax(d)
    assert list(on_dev) == list(host) == list(ref)
    for k in on_dev:
        assert on_dev[k].dtype == host[k].dtype == ref[k].dtype, k
        assert on_dev[k].shape == host[k].shape == ref[k].shape, k
        assert on_dev[k].tobytes() == host[k].tobytes(), k
        assert on_dev[k].tobytes() == ref[k].tobytes(), k
    if case not in ("int8", "bf16"):              # lossless: the final state
        for k, v in flatten_named(final).items():
            assert on_dev[k].tobytes() == np.asarray(v).tobytes(), k


def test_replayed_leaf_is_taken_as_is_and_checked(tmp_path):
    """TCL keeps the tensor the device replay produced (no second copy)
    and still checks its dtype against the template."""
    d = str(tmp_path / "t")
    ctx = CheckpointContext(CheckpointConfig(dir=d, block_bytes=BB,
                                             objstore=False,
                                             dedicated_thread=False))
    x = torch.arange(2048, dtype=torch.float32)
    ctx.store({"x": x}, id=1, level=1)
    x[7] = -1.0
    ctx.store({"x": x}, id=2, level=1, kind=CHK_DIFF)
    ctx.shutdown()
    ctx2 = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
    tcl = ctx2.tcl
    seen = {}
    real = tcl.backend.tcl_load

    def capture(req):
        out = real(req)
        seen.update(out)
        return out

    tcl.backend.tcl_load = capture
    got = ctx2.load({"x": torch.zeros(2048)})
    assert torch.equal(got["x"], x) and got["x"] is seen["x"]
    with pytest.raises(TypeError, match="dtype"):
        ctx2.load({"x": torch.zeros(2048, dtype=torch.float64)})
    ctx2.shutdown()


def test_leaf_reshaped_within_the_chain_replays_like_numpy(tmp_path):
    """A leaf stored with one shape and diffed with another of the same
    bytes: the device replay views the leaf with the delta's shape."""
    d = str(tmp_path / "r")
    ctx = CheckpointContext(CheckpointConfig(dir=d, block_bytes=BB,
                                             objstore=False,
                                             dedicated_thread=False))
    x = torch.arange(600, dtype=torch.float32)
    ctx.store({"x": x.reshape(20, 30)}, id=1, level=1)
    x[599] = -5.0
    rep = ctx.store({"x": x.reshape(30, 20)}, id=2, level=1, kind=CHK_DIFF)
    assert rep.kind == CHK_DIFF
    ctx.shutdown()
    eng = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
    host, _ = eng.tcl.backend.engine.load_latest()
    dev, _ = eng.tcl.backend.engine.load_latest(
        devices={"x": torch.device("cpu")})
    eng.shutdown()
    assert isinstance(dev["x"], torch.Tensor) and list(dev["x"].shape) == [30, 20]
    assert tensor_to_numpy(dev["x"]).tobytes() == host["x"].tobytes()
    assert host["x"].tobytes() == x.numpy().tobytes()


def test_device_replay_error_is_raised_not_taken_for_a_bad_checkpoint(
        tmp_path, monkeypatch):
    """FULL 1 + DIFF 2: when the scatter fails (on the card: a kernel that
    does not build or launch, a device out of memory), the restore raises;
    it does not warn and fall back to the FULL, losing the DIFF's step."""
    d = str(tmp_path / "e")
    ctx = CheckpointContext(CheckpointConfig(dir=d, block_bytes=BB,
                                             objstore=False,
                                             dedicated_thread=False))
    x = torch.arange(2048, dtype=torch.float32)
    ctx.store({"x": x}, id=1, level=1)
    x[7] = -1.0
    ctx.store({"x": x}, id=2, level=1, kind=CHK_DIFF)
    ctx.shutdown()

    def broken(*_a, **_k):
        raise RuntimeError("diffunpack: launch failed")

    monkeypatch.setattr(ops, "unpack_dirty_many", broken)
    eng = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # nor a fallback
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.tcl.backend.engine.load_latest(
                devices={"x": torch.device("cpu")})
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.load({"x": torch.zeros(2048)})
    # the host replay does not scatter through it, and finds id 2
    host, meta = eng.tcl.backend.engine.load_latest()
    eng.shutdown()
    assert meta["id"] == 2 and host["x"].tobytes() == x.numpy().tobytes()


def _numpy_replay(pkg, base, deltas, dtype, shape):
    buf = pkg.leaf_to_u32_flat(base, BB)
    for idx, rows in deltas:
        buf = pkg.apply_delta(buf, idx, rows, BB)
    return pkg.u32_flat_to_leaf(buf, dtype, shape)


def _rows(rng, idx):
    return rng.randint(0, 2**32, size=(len(idx), BB // 4), dtype=np.uint64
                       ).astype(np.uint32)


#: base, then (dirty blocks, dtype, shape) per delta: leaves that change
#: dtype or size within the chain, as the numpy replay reinterprets them
_LAYOUTS = {
    "same": (np.float32, 1000, [([0, 15], "<f4", [1000]),
                                ([3], "<f4", [1000])]),
    "shrink": (np.float32, 1000, [([15], "<f4", [990])]),
    "grow within the padding": (np.float32, 1001, [([0], "<f4", [1020])]),
    "shrink then grow": (np.float32, 1000, [([2, 14], "<f4", [900]),
                                            ([0], "<f4", [1000])]),
    "rows past the final end": (np.float32, 1000, [([1, 13, 15], "<f4",
                                                    [1000]),
                                                   ([1], "|u1", [3000])]),
    "dtype and shape": (ml_dtypes.bfloat16, 1001, [([0, 7], "<f2",
                                                    [13, 77]),
                                                   ([7], "<i4", [500])]),
    "0-d": (np.int32, None, [([0], "<i4", [])]),
    "to empty": (np.float32, 10, [([0], "<f4", [0])]),
}


@pytest.mark.parametrize("case", list(_LAYOUTS))
def test_tensor_replay_equals_numpy_replay_across_layouts(case):
    """A leaf whose dtype or byte count changes within the chain replays on
    its device to the bytes the numpy replay of both packages gives."""
    dt0, n0, spec = _LAYOUTS[case]
    rng = np.random.RandomState(len(case))
    base = (rng.randn(n0) * 100).astype(dt0) if n0 is not None else \
        np.asarray(np.int32(7))
    deltas = [(np.asarray(i, np.int32), _rows(rng, i)) for i, _, _ in spec]
    dtype, shape = spec[-1][1], spec[-1][2]
    want = _numpy_replay(jdiff, base, deltas, dtype, shape)
    assert _numpy_replay(tdiff, base, deltas, dtype, shape).tobytes() == \
        want.tobytes()
    replay = ChainReplay()
    replay.start("x", base, BB)
    for link, ((idx, rows), (_, dt, shp)) in enumerate(zip(deltas, spec)):
        replay.add("x", link + 1, idx, rows, BB, dt, shp)
    replay.finish()
    got = replay.run({"x": torch.device("cpu")})["x"]
    assert isinstance(got, torch.Tensor) and got.is_contiguous()
    got = tensor_to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_tensor_replay_refuses_on_the_host_what_the_numpy_replay_refuses():
    base = np.arange(1000, dtype=np.float32)            # 16 blocks of 256 B
    rows = np.zeros((1, BB // 4), np.uint32)

    def replay():
        r = ChainReplay()
        r.start("x", base, BB)
        return r

    with pytest.raises(IndexError):
        _numpy_replay(jdiff, base, [(np.array([16], np.int32), rows)],
                      "<f4", [1000])
    with pytest.raises(IndexError, match="outside"):
        replay().add("x", 1, np.array([16], np.int32), rows, BB, "<f4",
                     [1000])
    with pytest.raises(ValueError):                     # outgrows the buffer
        _numpy_replay(jdiff, base, [(np.array([0], np.int32), rows)],
                      "<f4", [1100])
    r = replay()
    r.add("x", 1, np.array([0], np.int32), rows, BB, "<f4", [1100])
    with pytest.raises(ValueError, match="outgrows"):
        r.finish()
    with pytest.raises(ValueError, match="packed rows"):
        replay().add("x", 1, np.array([0, 1], np.int32), rows, BB, "<f4",
                     [1000])


def test_empty_leaf_from_numpy_hashes_like_the_reference():
    """A 0-element tensor made from an empty numpy array (as a restore
    makes it) carries a stride of 0; hashing it — the next store of a
    restored state does — must give the reference's one padded digest."""
    from repro.kernels import ops as jops
    e = numpy_to_tensor(np.zeros((0,), np.float32))
    got = ops.u32_numpy(ops.blockhash(e, BB))
    want = np.asarray(jops.blockhash(jnp.zeros((0,), jnp.float32), BB))
    assert got.shape == (1, 2) and np.array_equal(got, want)
