"""The port's directive store/restart path on the CPU: the recovery ladder,
checkpoints cross-read between the two packages in both directions, and
the hazards torch's in-place updates bring.

Cross-read: a checkpoint written by ``repro`` (JAX) restores in
``repro_torch`` to exactly the bytes ``repro`` restores itself, and the
other way round — FULL, a DIFF chain, a mixed-kind store, ``int8``
compression and ``bf16`` precision.  Inputs are numpy arrays from a seed,
handed to both packages.
"""
import os
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import context as jctx
from repro_torch.backends.registry import make_backend
from repro_torch.core.comm import SimulatedCluster
from repro_torch.core.context import (
    CHK_DIFF,
    CHK_FULL,
    CheckpointConfig,
    CheckpointContext,
    Protect,
)
from repro_torch.core.pipeline import StoreRequest
from repro_torch.core.protect import (
    flatten_named,
    from_numpy_named,
    to_host,
    unflatten_named,
)
from repro_torch.core.storage import StorageConfig

WORLD = 4


# --------------------------------------------------------------------------- #
# the FTI ladder on a simulated cluster (tests/test_pipeline.py, ported)
# --------------------------------------------------------------------------- #

def _named(rank, val=None):
    return {"w": torch.full((256,), float(val if val is not None else rank)),
            "step": torch.tensor(rank, dtype=torch.int32)}


def _backends(tmp_path, name, objstore=False):
    cluster = SimulatedCluster(str(tmp_path / "cluster"), WORLD)
    cfg = StorageConfig(root=str(tmp_path / "shared"), group_size=4,
                        block_bytes=256, objstore=objstore)
    kw = {"dedicated_thread": False} if name == "fti" else {}
    return cluster, [make_backend(cfg, c, name, **kw) for c in cluster.comms]


@pytest.mark.parametrize("backend", ["fti", "veloc"])
@pytest.mark.parametrize("kind", [CHK_FULL, CHK_DIFF])
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_store_crash_restart_ladder(tmp_path, backend, kind, level):
    """Store → simulated node crash → restart for every level × backend ×
    kind; recovery comes from the expected ladder rung."""
    cluster, backends = _backends(tmp_path, backend)
    newest = 0
    for r, b in enumerate(backends):
        b.tcl_store(_named(r), 1, level, CHK_FULL)
        b.tcl_wait()
        newest = 1
        if kind == CHK_DIFF:
            named2 = _named(r)
            named2["w"][3] = -7.0
            b.tcl_store(named2, 2, level, CHK_DIFF)
            b.tcl_wait()
            newest = 2
    victim = 1
    named, meta = backends[victim].engine.load_latest()
    assert meta["recovered_via"] == ("global" if level == 4 else "local")
    if level > 1:
        cluster.kill_node(victim)
        got = backends[victim].engine.load_latest()
        assert got is not None, f"L{level} recovery failed after node loss"
        named, meta = got
        assert meta["recovered_via"] == {2: "partner", 3: "erasure",
                                         4: "global"}[level]
    if kind == CHK_DIFF and backend == "fti":
        assert named["w"][3] == -7.0 and meta["kind"] == CHK_DIFF
    else:
        assert named["w"][0] == float(victim)
    assert int(named["step"]) == victim and meta["id"] == newest
    for b in backends:
        b.tcl_finalize()


def test_pending_parts_of_the_port_refuse_loudly(tmp_path):
    """The object-store L4, SCR and incremental stores are later slices:
    each raises NotImplementedError instead of silently doing less."""
    cluster, backends = _backends(tmp_path, "fti", objstore=True)
    names = [t.name for t in backends[0].pipeline.ladder]
    assert names == ["local", "partner", "erasure", "global", "objstore"]
    assert backends[0].capabilities()["objstore"] is False
    with pytest.raises(NotImplementedError, match="object-store"):
        backends[0].tcl_store(_named(0), 1, 4, CHK_FULL)
    backends[0].tcl_store(_named(0), 2, 1, CHK_FULL)     # L1 still works
    assert backends[0].engine.load_latest()[1]["id"] == 2
    with pytest.raises(NotImplementedError, match="incremental"):
        backends[0].tcl_store_begin(3, 1)
    with pytest.raises(NotImplementedError, match="SCR"):
        make_backend(StorageConfig(root=str(tmp_path / "s")),
                     cluster.comms[0], "scr")


# --------------------------------------------------------------------------- #
# cross-read between the packages
# --------------------------------------------------------------------------- #

def _state_np(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"w": rng.randn(300, 7).astype(np.float32),
                       "b": rng.randn(50).astype(ml_dtypes.bfloat16)},
            "step": np.asarray(np.int32(seed))}


def _edit(st, seed):
    rng = np.random.RandomState(100 + seed)
    out = {"params": {k: v.copy() for k, v in st["params"].items()},
           "step": np.asarray(np.int32(int(st["step"]) + 1))}
    for i in rng.randint(0, out["params"]["w"].size, size=4):
        out["params"]["w"].reshape(-1)[i] += 1.0
    out["params"]["b"][rng.randint(0, 50)] += 1
    return out


def _protects(P, case):
    return {
        "full": None, "diff_chain": None,
        "mixed": [P("params/**", kind=CHK_DIFF), P("step")],
        "int8": [P("params/w", compress="int8"), P("params/b"), P("step")],
        "bf16": [P("params/w", precision="bf16"), P("params/b"), P("step")],
    }[case]


_STORES = {"full": [(1, CHK_FULL)],
           "diff_chain": [(1, CHK_FULL), (2, CHK_DIFF), (3, CHK_DIFF)],
           "mixed": [(1, CHK_FULL), (2, CHK_FULL)],
           "int8": [(1, CHK_FULL)], "bf16": [(1, CHK_FULL)]}


def _write(pkg, d, case):
    """Store the case's state sequence with package ``pkg`` → final state."""
    st = _state_np(0)
    if pkg == "jax":
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
            dir=d, backend="fti", block_bytes=256, objstore=False))
        ps = _protects(jctx.Protect, case)
        conv = lambda s: {"params": {k: jnp.asarray(v) for k, v in
                                     s["params"].items()},
                          "step": jnp.asarray(s["step"])}
    else:
        ctx = CheckpointContext(CheckpointConfig(
            dir=d, backend="fti", block_bytes=256, objstore=False))
        ps = _protects(Protect, case)
        conv = lambda s: unflatten_named(
            from_numpy_named(flatten_named(s)), s)
    if ps:
        ctx.protect(*ps)
    for i, (ckpt_id, kind) in enumerate(_STORES[case]):
        if i:
            st = _edit(st, i)
        ctx.store(conv(st), id=ckpt_id, level=1, kind=kind)
    ctx.shutdown()
    return st


def _read(pkg, d, case):
    """Restore with package ``pkg`` into a zeros template → numpy tree."""
    zeros = _state_np(0)
    zeros = {"params": {k: np.zeros_like(v) for k, v in
                        zeros["params"].items()},
             "step": np.zeros((), np.int32)}
    if pkg == "jax":
        ctx = jctx.CheckpointContext(jctx.CheckpointConfig(
            dir=d, backend="fti", objstore=False))
        ps = _protects(jctx.Protect, case)
        tmpl = {"params": {k: jnp.asarray(v) for k, v in
                           zeros["params"].items()},
                "step": jnp.asarray(zeros["step"])}
    else:
        ctx = CheckpointContext(CheckpointConfig(
            dir=d, backend="fti", objstore=False))
        ps = _protects(Protect, case)
        tmpl = unflatten_named(from_numpy_named(flatten_named(zeros)), zeros)
    if ps:
        ctx.protect(*ps)
    got = ctx.load(tmpl)
    assert ctx.restarted
    ctx.shutdown()
    if pkg == "jax":
        return {k: np.asarray(v) for k, v in flatten_named(
            {"params": dict(got["params"]), "step": got["step"]}).items()}
    return to_host(flatten_named(got))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", list(_STORES))
def test_cross_read_both_directions(tmp_path, writer, case):
    d = str(tmp_path / "ck")
    final = _write(writer, d, case)
    if case in ("diff_chain", "mixed"):        # the newest link is a delta
        probe = CheckpointContext(CheckpointConfig(dir=d, objstore=False))
        assert probe.tcl.backend.engine.load_latest()[1]["kind"] == CHK_DIFF
        probe.shutdown()
    own = _read(writer, d, case)
    other = _read("torch" if writer == "jax" else "jax", d, case)
    assert list(own) == list(other)
    for k in own:
        assert own[k].dtype == other[k].dtype and own[k].shape == other[k].shape
        assert own[k].tobytes() == other[k].tobytes(), k
    if case not in ("int8", "bf16"):            # lossless: the final state
        for k, v in flatten_named(final).items():
            assert own[k].tobytes() == np.asarray(v).tobytes(), k


# --------------------------------------------------------------------------- #
# in-place updates: what Plan must have copied before it returns
# --------------------------------------------------------------------------- #

def _ctx(tmp_path, name, **kw):
    return CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / name), backend="fti", block_bytes=256,
        objstore=False, **kw))


def test_async_full_then_inplace_update_then_diff_restores_final(tmp_path):
    """The FULL's tail runs on the CP thread; the update lands before it
    ran.  The DIFF must still see the updated blocks as dirty (Plan hashed
    the bytes it stored), and restore the final state."""
    ctx = _ctx(tmp_path, "a", dedicated_thread=True)
    x = torch.arange(4096, dtype=torch.float32)
    s = torch.tensor(0)
    ctx.store({"x": x, "s": s}, id=1, level=1)
    x[5] = -1.0
    x[3000] = -2.0
    s += 1
    ctx.store({"x": x, "s": s}, id=2, level=1, kind=CHK_DIFF)
    ctx.wait()
    ctx.shutdown()
    ctx2 = _ctx(tmp_path, "a")
    named, meta = ctx2.tcl.backend.engine.load_latest()
    assert meta["kind"] == CHK_DIFF and meta["id"] == 2
    got = ctx2.load({"x": torch.zeros(4096), "s": torch.tensor(0)})
    assert torch.equal(got["x"], x) and int(got["s"]) == 1
    ctx2.shutdown()


@pytest.mark.parametrize("kind", [CHK_FULL, CHK_DIFF])
def test_plan_then_inplace_update_stores_pre_update_bytes(tmp_path, kind):
    """After plan() returns, the caller may update its tensors in place (an
    optimizer step): the tail packs what Plan copied, never the new bytes."""
    ctx = _ctx(tmp_path, "p", dedicated_thread=False)
    pipe = ctx.tcl.backend.pipeline
    x = torch.arange(2048, dtype=torch.float32)
    ctx.store({"x": x}, id=1, level=1)
    x[10] = 5.0
    want = x.clone()
    plan = pipe.plan(StoreRequest(named={"x": x}, ckpt_id=2, level=1,
                                  kind=kind))
    x.mul_(-1.0)                                    # after Plan, before Pack
    rep = pipe.finish(plan)
    assert rep.kind == kind and rep.plan_seconds > 0.0
    named, meta = ctx.tcl.backend.engine.load_latest()
    assert meta["id"] == 2
    assert named["x"].tobytes() == want.numpy().tobytes()
    ctx.shutdown()


def test_sync_store_failure_invalidates_digest_chain(tmp_path):
    """A store that fails after Plan advanced the digest chain invalidates
    it — the next DIFF promotes instead of delta'ing phantom data."""
    ctx = _ctx(tmp_path, "s", dedicated_thread=False)
    eng = ctx.tcl.backend.engine
    x = torch.arange(1024, dtype=torch.float32)
    ctx.store({"x": x}, id=1, level=1)
    shutil.rmtree(eng.local_root)
    open(eng.local_root, "w").write("not a dir")
    with pytest.raises(OSError):
        ctx.store({"x": x * -1.0}, id=2, level=1)
    os.remove(eng.local_root)
    os.makedirs(eng.local_root)
    x[0] = 5.0
    rep = ctx.store({"x": x}, id=3, level=1, kind=CHK_DIFF)
    assert rep.kind == CHK_FULL and rep.promoted_full
    ctx.shutdown()
    ctx2 = _ctx(tmp_path, "s")
    got = ctx2.load({"x": torch.zeros(1024)})
    assert float(got["x"][0]) == 5.0 and float(got["x"][1]) == 1.0
    ctx2.shutdown()


def test_aborted_plan_invalidates_its_digests(tmp_path):
    """Plan commits a FULL's digests; a store whose tail never runs (the CP
    submit raised) drops them, so the next DIFF promotes instead of
    diffing against bytes no checkpoint holds."""
    ctx = _ctx(tmp_path, "ab", dedicated_thread=False)
    pipe = ctx.tcl.backend.pipeline
    x = torch.arange(2048, dtype=torch.float32)
    ctx.store({"x": x}, id=1, level=1)
    x[7] = -3.0
    plan = pipe.plan(StoreRequest(named={"x": x}, ckpt_id=2, level=1))
    probe, _ = pipe.diff.compute_deltas({"x": x.clone()})
    assert probe is not None and probe[0].dirty_idx.size == 0  # committed
    pipe.abort_plan(plan)
    rep = ctx.store({"x": x}, id=3, level=1, kind=CHK_DIFF)
    assert rep.kind == CHK_FULL and rep.promoted_full
    ctx.shutdown()
    ctx2 = _ctx(tmp_path, "ab")
    got = ctx2.load({"x": torch.zeros(2048)})
    assert torch.equal(got["x"], x)
    ctx2.shutdown()


def test_restore_follows_template_device_and_dtype(tmp_path):
    ctx = _ctx(tmp_path, "t")
    ctx.store({"x": torch.arange(8, dtype=torch.float32),
               "h": torch.ones(3, dtype=torch.bfloat16)}, id=1, level=1)
    ctx.shutdown()
    ctx2 = _ctx(tmp_path, "t")
    got = ctx2.load({"x": torch.zeros(8), "h": torch.zeros(3,
                                                            dtype=torch.bfloat16)})
    assert got["h"].dtype == torch.bfloat16 and got["x"].device.type == "cpu"
    with pytest.raises(TypeError, match="dtype"):
        ctx2.load({"x": torch.zeros(8, dtype=torch.float64),
                   "h": torch.zeros(3, dtype=torch.bfloat16)})
    ctx2.shutdown()


# --------------------------------------------------------------------------- #
# the backends' native APIs, and the whole slice as chip_smoke.py drives it
# --------------------------------------------------------------------------- #

def test_fti_and_veloc_native_apis(tmp_path):
    from repro_torch.backends.fti import FTIBackend
    from repro_torch.backends.veloc import VELOC_SUCCESS, VeloCBackend
    from repro_torch.core.comm import LocalComm

    w = torch.arange(600, dtype=torch.float32)
    fti = FTIBackend(StorageConfig(root=str(tmp_path / "f"), block_bytes=256,
                                   objstore=False),
                     LocalComm(str(tmp_path / "f" / "nl")),
                     dedicated_thread=False)
    fti.protect(0, "w", w)
    fti.checkpoint(1, 1)
    w[300] = -3.0
    rep = fti.checkpoint(2, 1, differential=True)
    assert rep.kind == CHK_DIFF and fti.status()
    assert fti.recover()[0].tobytes() == w.numpy().tobytes()
    fti.finalize()

    vel = VeloCBackend(StorageConfig(root=str(tmp_path / "v"), objstore=False),
                       LocalComm(str(tmp_path / "v" / "nl")))
    assert vel.mem_protect(0, w, "w") == VELOC_SUCCESS
    assert vel.checkpoint("run", 7) == VELOC_SUCCESS
    assert vel.checkpoint_wait() == VELOC_SUCCESS
    assert vel.restart_test("run") == 7
    assert vel.restart("run", 7) == VELOC_SUCCESS
    assert vel.recovered(0).tobytes() == w.numpy().tobytes()
    vel.tcl_finalize()

