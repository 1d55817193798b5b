"""The port's directive store/restart path on the CPU: the recovery ladder
({fti, scr, veloc} × {FULL, DIFF, incremental} × L1–L4, as
tests/test_pipeline.py runs it), async composition and deferred errors,
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
from repro_torch.core.comm import LocalComm, SimulatedCluster
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


def _store(b, rank, kind, level):
    """One committed checkpoint of ``kind`` on backend ``b`` (id of the
    newest)."""
    if kind == "INC":
        inc = b.tcl_store_begin(1, level)
        inc.add({"w": _named(rank)["w"]})
        inc.add({"step": _named(rank)["step"]})
        inc.commit()
        b.tcl_wait()
        return 1
    b.tcl_store(_named(rank), 1, level, CHK_FULL)
    b.tcl_wait()
    if kind == CHK_DIFF:
        named2 = _named(rank)
        named2["w"][3] = -7.0
        b.tcl_store(named2, 2, level, CHK_DIFF)
        b.tcl_wait()
        return 2
    return 1


def test_recovery_ladder_is_l1_to_l4(tmp_path):
    """The read path tries tiers in FTI's ladder order L1→L2→L3→L4, with
    the object store as the final rung."""
    cluster, backends = _backends(tmp_path, "fti", objstore=True)
    names = [t.name for t in backends[0].pipeline.ladder]
    assert names == ["local", "partner", "erasure", "global", "objstore"]
    levels = [t.level for t in backends[0].pipeline.ladder]
    assert levels == sorted(levels) == [1, 2, 3, 4, 5]
    assert backends[0].capabilities()["objstore"] is True


@pytest.mark.parametrize("backend", ["fti", "scr", "veloc"])
@pytest.mark.parametrize("kind", [CHK_FULL, CHK_DIFF, "INC"])
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_store_crash_restart_ladder(tmp_path, backend, kind, level):
    """Store → simulated node crash → restart for every level × backend ×
    store kind (FULL, a DIFF chain, an incremental store in two parts);
    recovery comes from the expected ladder rung."""
    cluster, backends = _backends(tmp_path, backend)
    newest = 0
    for r, b in enumerate(backends):
        newest = _store(b, r, kind, level)
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


@pytest.mark.parametrize("level", [2, 3])
def test_incremental_gets_level_redundancy(tmp_path, level):
    """Level-2/3 incremental checkpoints are replicated/encoded at commit
    and survive a node loss."""
    cluster, backends = _backends(tmp_path, "fti")
    for r, b in enumerate(backends):
        inc = b.tcl_store_begin(5, level)
        inc.add({"w": torch.full((64,), float(r))})
        rep = inc.commit()
        assert rep is not None and rep.level == level
        b.tcl_wait()
    cluster.kill_node(2)
    got = backends[2].engine.load_latest()
    assert got is not None
    named, meta = got
    assert named["w"][0] == 2.0
    assert meta["incremental"] is True
    assert meta["recovered_via"] == ("partner" if level == 2 else "erasure")


def test_incremental_async_commit_composes(tmp_path):
    """With a CP-dedicated thread, store_begin does not fence in-flight
    stores, and commit runs Place→Commit asynchronously."""
    cfg = CheckpointConfig(dir=str(tmp_path / "a"), backend="fti",
                           dedicated_thread=True)
    ctx = CheckpointContext(cfg)
    ctx.store({"w": torch.arange(8.0)}, id=1, level=1)   # async, not waited
    inc = ctx.store_begin(id=2, level=1)                 # no fence on 1
    inc.add({"w": torch.arange(8.0) + 1})
    assert inc.commit() is None                # async tail → report deferred
    ctx.wait()
    ctx.shutdown()
    ctx2 = CheckpointContext(cfg)
    got = ctx2.load({"w": torch.zeros(8)})
    assert ctx2.restarted and torch.equal(got["w"], torch.arange(8.0) + 1)
    ctx2.shutdown()


def test_async_diff_chain_composes(tmp_path):
    """Back-to-back DIFF stores on the CP thread keep a consistent digest
    chain (Plan runs synchronously in submission order)."""
    cfg = CheckpointConfig(dir=str(tmp_path / "d"), backend="fti",
                           dedicated_thread=True, block_bytes=256,
                           keep_last_full=2)
    ctx = CheckpointContext(cfg)
    x = torch.arange(4096, dtype=torch.float32)
    ctx.store({"x": x}, id=1, level=1)                      # FULL
    x[5] = -1.0                                             # in place
    ctx.store({"x": x}, id=2, level=1, kind=CHK_DIFF)       # async DIFF
    x[900] = -2.0
    ctx.store({"x": x}, id=3, level=1, kind=CHK_DIFF)       # async DIFF
    ctx.wait()
    ctx.shutdown()
    ctx2 = CheckpointContext(CheckpointConfig(dir=str(tmp_path / "d"),
                                              backend="fti"))
    got = ctx2.load({"x": torch.zeros(4096)})
    assert float(got["x"][5]) == -1.0 and float(got["x"][900]) == -2.0
    ctx2.shutdown()


def test_full_digests_are_hashed_in_plan_on_the_calling_thread(
        tmp_path, monkeypatch):
    """The port's decision where the reference defers a FULL's digests to
    the CP thread: Plan hashes every leaf of every store, FULL and DIFF,
    on the calling thread before it returns (torch tensors change in
    place, so the digests must describe the snapshot Plan took).  An
    interleaved FULL/DIFF chain still commits real DIFF links that replay
    every update."""
    import threading

    import repro_torch.core.diff as diff_mod
    main = threading.get_ident()
    hash_threads = []
    real = diff_mod.ops.blockhash
    monkeypatch.setattr(
        diff_mod.ops, "blockhash",
        lambda leaf, bb: hash_threads.append(threading.get_ident())
        or real(leaf, bb))
    cfg = CheckpointConfig(dir=str(tmp_path / "h"), backend="fti",
                           dedicated_thread=True, block_bytes=256)
    ctx = CheckpointContext(cfg)
    x = torch.arange(4096, dtype=torch.float32)
    ctx.store({"x": x}, id=1, level=1)                      # FULL, async
    x[7] = -1.0
    ctx.store({"x": x}, id=2, level=1, kind=CHK_DIFF)
    x[2048] = -2.0
    ctx.store({"x": x}, id=3, level=1)                      # FULL again
    x[9] = -3.0
    ctx.store({"x": x}, id=4, level=1, kind=CHK_DIFF)
    ctx.wait()
    ctx.shutdown()
    assert hash_threads == [main] * 4
    ctx2 = CheckpointContext(CheckpointConfig(dir=str(tmp_path / "h"),
                                              backend="fti"))
    named, meta = ctx2.tcl.backend.engine.load_latest()
    assert meta["kind"] == CHK_DIFF and meta["id"] == 4
    assert named["x"][7] == -1.0 and named["x"][2048] == -2.0
    assert named["x"][9] == -3.0
    ctx2.shutdown()


def _break_local_tier(eng):
    """A file where the checkpoint tree must go → the next write fails."""
    shutil.rmtree(eng.local_root)
    with open(eng.local_root, "w") as f:
        f.write("not a dir")


def _mend_local_tier(eng):
    os.remove(eng.local_root)
    os.makedirs(eng.local_root)


def test_deferred_error_surfaces_before_digest_mutation(tmp_path):
    """A failed async store raises at the next directive BEFORE that
    directive's Plan advances the digest chain; after the error surfaced,
    the context keeps working."""
    cfg = CheckpointConfig(dir=str(tmp_path / "e"), backend="fti",
                           dedicated_thread=True, block_bytes=256)
    ctx = CheckpointContext(cfg)
    eng = ctx.tcl.backend.engine
    x = torch.arange(1024, dtype=torch.float32)
    ctx.store({"x": x}, id=1, level=1)
    ctx.wait()
    _break_local_tier(eng)
    y = x.clone()
    y[0] = -1.0
    ctx.store({"x": y}, id=2, level=1, kind=CHK_DIFF)
    ctx.tcl.backend._cp.wait()              # let the failure land
    digests_before = dict(eng.diff._digests)
    y[1] = -2.0
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        ctx.store({"x": y}, id=3, level=1, kind=CHK_DIFF)
    assert all(np.array_equal(digests_before[k], v)
               for k, v in eng.diff._digests.items())
    _mend_local_tier(eng)
    ctx.store({"x": x}, id=4, level=4)
    ctx.wait()
    inc = ctx.store_begin(id=5, level=1)
    inc.add({"x": x})
    inc.commit()
    ctx.wait()
    ctx.shutdown()


def test_incremental_commit_retryable_after_deferred_error(tmp_path):
    """A deferred error raised inside commit() leaves the store
    uncommitted and retryable."""
    cfg = CheckpointConfig(dir=str(tmp_path / "r"), backend="fti",
                           dedicated_thread=True, block_bytes=256)
    ctx = CheckpointContext(cfg)
    eng = ctx.tcl.backend.engine
    ctx.store({"x": torch.ones(16)}, id=1, level=1)
    ctx.wait()
    _break_local_tier(eng)
    ctx.store({"x": torch.zeros(16)}, id=2, level=1)      # async fail
    ctx.tcl.backend._cp.wait()
    _mend_local_tier(eng)
    inc = ctx.store_begin(id=3, level=1)
    inc.add({"w": torch.ones(4)})
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        inc.commit()
    assert inc.commit() is None             # retry succeeds (async tail)
    ctx.wait()
    ctx.shutdown()


def test_shutdown_surfaces_final_async_error(tmp_path):
    """A failure in the very last async store does not vanish at
    shutdown."""
    ctx = CheckpointContext(CheckpointConfig(dir=str(tmp_path / "f"),
                                             backend="fti",
                                             dedicated_thread=True))
    _break_local_tier(ctx.tcl.backend.engine)
    ctx.store({"x": torch.ones(4)}, id=1, level=1)    # async, will fail
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        ctx.shutdown()


def test_config_dedicated_thread_reaches_veloc(tmp_path):
    """dedicated_thread=False in the user config makes VeloC synchronous
    too, not just FTI."""
    ctx = CheckpointContext(CheckpointConfig(dir=str(tmp_path / "v"),
                                             backend="veloc",
                                             dedicated_thread=False))
    assert ctx.tcl.backend._cp is None
    rep = ctx.store({"x": torch.ones(8)}, id=1, level=1)
    assert rep is not None and rep.kind == CHK_FULL    # sync → report now
    ctx.shutdown()


def test_backend_capabilities_and_shared_stacks(tmp_path):
    """Backends declare capabilities and compose the shared tier stacks —
    none re-implements placement."""
    caps = {}
    for name in ("fti", "scr", "veloc"):
        b = make_backend(StorageConfig(root=str(tmp_path / name)),
                         LocalComm(str(tmp_path / name / "nl")), name)
        caps[name] = b.capabilities()
        assert sorted(b.pipeline.stacks) == [1, 2, 3, 4]
        assert [t.name for t in b.pipeline.stacks[3]] == ["local", "erasure"]
        b.tcl_finalize()
    assert caps["fti"]["diff"] and not caps["scr"]["diff"]
    assert caps["veloc"]["dedicated_thread"]
    assert not caps["scr"]["dedicated_thread"]


def test_pending_parts_of_the_port_refuse_loudly(tmp_path):
    """The parts earlier slices left out — the object-store L4, SCR and
    incremental stores — now work: a level-4 store publishes a catalog
    entry, an incremental store commits, and SCR stores and restores.
    Nothing raises NotImplementedError any more."""
    cluster, backends = _backends(tmp_path, "fti", objstore=True)
    names = [t.name for t in backends[0].pipeline.ladder]
    assert names == ["local", "partner", "erasure", "global", "objstore"]
    assert backends[0].capabilities()["objstore"] is True
    backends[0].tcl_store(_named(0), 1, 4, CHK_FULL)
    assert backends[0].engine.objstore_tier().catalog.ids() == [1]
    backends[0].tcl_store(_named(0), 2, 1, CHK_FULL)
    assert backends[0].engine.load_latest()[1]["id"] == 2
    inc = backends[0].tcl_store_begin(3, 1)
    inc.add(_named(0, 5.0))
    assert inc.commit().kind == CHK_FULL
    named, meta = backends[0].engine.load_latest()
    assert meta["id"] == 3 and meta["incremental"] and named["w"][0] == 5.0
    scr = make_backend(StorageConfig(root=str(tmp_path / "s")),
                       LocalComm(str(tmp_path / "s" / "nl")), "scr")
    scr.tcl_store(_named(0, 2.0), 1, 4, CHK_FULL)
    assert scr.tcl_load()["w"][0] == 2.0
    for b in backends:
        b.tcl_finalize()


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

