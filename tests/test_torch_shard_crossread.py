"""Shard files cross-read between the JAX package and the port, bit for
bit, on the CPU: ``write_shard_files`` sets and ``save_sharded`` rank
files written by either package are read by the other's
``ElasticLoader`` / ``elastic_restore`` for any region and any
``(world, rank)``; a shard-local FULL built by either package's
``StorageEngine`` restores in the other; and a ``NamedSharding`` state
stored through ``repro``'s context on a forced-4-device mesh restores in
``repro_torch`` at the same id, with the same ``chkls --json`` shard
inventory."""
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

import repro.core.resharding as ref_rs
import repro_torch.core.resharding as rs
from repro.core.comm import LocalComm as RefLocalComm
from repro.core.formats import CHK5Writer as RefCHK5Writer
from repro.core.protect import Protect as RefProtect
from repro.core.storage import StorageConfig as RefStorageConfig
from repro.core.storage import StorageEngine as RefStorageEngine
from repro.core.storage import StoreRequest as RefStoreRequest
from repro_torch.core.comm import LocalComm
from repro_torch.core.context import CheckpointConfig, CheckpointContext
from repro_torch.core.formats import CHK5Writer
from repro_torch.core.protect import Protect
from repro_torch.core.storage import StorageConfig, StorageEngine, StoreRequest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: package name → (resharding module, CHK5Writer, Protect, engine parts)
PKGS = {
    "repro": (ref_rs, RefCHK5Writer, RefProtect,
              (RefStorageConfig, RefStorageEngine, RefStoreRequest,
               RefLocalComm)),
    "repro_torch": (rs, CHK5Writer, Protect,
                    (StorageConfig, StorageEngine, StoreRequest, LocalComm)),
}
DIRECTIONS = [("repro", "repro_torch"), ("repro_torch", "repro")]


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(23, 10)).astype(np.float32),
        "q": rng.normal(size=(16, 12)).astype(np.float32),   # int8 codec
        "i": rng.integers(-9, 9, size=(11, 3, 2)).astype(np.int32),
        "v": rng.normal(size=(17,)).astype(np.float64),
    }


def _grid_chunks(mod, a, cuts0, cuts1=None):
    """Chunks of ``a`` on a grid of row cuts × column cuts (ragged)."""
    r_edges = [0, *cuts0, a.shape[0]]
    c_edges = [0, *(cuts1 or []), a.shape[1]] if a.ndim > 1 else [None]
    out = []
    for r0, r1 in zip(r_edges, r_edges[1:]):
        if a.ndim == 1:
            out.append(mod.ShardChunk((r0,), (r1 - r0,), a[r0:r1]))
            continue
        for c0, c1 in zip(c_edges, c_edges[1:]):
            piece = a[r0:r1, c0:c1]
            out.append(mod.ShardChunk((r0, c0) + (0,) * (a.ndim - 2),
                                      piece.shape, piece))
    return out


def _write_set(pkg, d, arrays):
    mod, writer, protect, _ = PKGS[pkg]
    snaps = {
        "w": mod.ShardSnapshot("<f4", arrays["w"].shape,
                               _grid_chunks(mod, arrays["w"], [7, 15], [4])),
        "q": mod.ShardSnapshot("<f4", arrays["q"].shape,
                               _grid_chunks(mod, arrays["q"], [8], [6])),
        "i": mod.ShardSnapshot("<i4", arrays["i"].shape,
                               _grid_chunks(mod, arrays["i"], [5])),
        "v": mod.ShardSnapshot("<f8", arrays["v"].shape,
                               _grid_chunks(mod, arrays["v"], [3, 9])),
    }
    specs = {"q": protect("q", compress="int8")}
    with writer(os.path.join(d, "rank0.chk5")) as w:
        files = mod.write_shard_files(d, "rank0", w, snaps, specs=specs,
                                      max_writers=3)
    return sorted(files)


def _regions(shape, rng, n=12):
    out = [None]
    for _ in range(n):
        box = []
        for dim in shape:
            lo = int(rng.integers(0, dim))
            box.append(slice(lo, int(rng.integers(lo + 1, dim + 1))))
        out.append(tuple(box))
    return out


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_shard_file_sets_cross_read_any_region(tmp_path, writer, reader):
    """A multi-dim shard-file set (ragged grid chunks, an int8-coded leaf,
    int32 and f64 leaves) written by one package reads in the other, for
    every region and every ``(world, rank)``, equal to what the writing
    package reads itself."""
    arrays = _arrays()
    files = _write_set(writer, str(tmp_path), arrays)
    theirs = PKGS[writer][0].ElasticLoader(files)
    mine = PKGS[reader][0].ElasticLoader(files)
    rng = np.random.default_rng(1)
    try:
        assert mine.names() == theirs.names() == sorted(arrays)
        for name, a in arrays.items():
            assert mine.global_shape(name) == list(a.shape)
            assert mine.dtype(name) == a.dtype
            for box in _regions(a.shape, rng):
                got = mine.read_region(name, box)
                want = theirs.read_region(name, box)
                assert got.dtype == want.dtype
                assert got.tobytes() == want.tobytes(), (name, box)
                if name != "q":                 # raw chunks: the source
                    exact = a if box is None else a[box]
                    assert got.tobytes() == exact.tobytes()
            for world in range(1, 6):
                for rank in range(world):
                    got = mine.read_for_rank(name, world, rank)
                    want = theirs.read_for_rank(name, world, rank)
                    assert got.tobytes() == want.tobytes()
    finally:
        mine.close()
        theirs.close()
    # the lazy refs of the index in the main container read the same
    rd = PKGS[reader][0].CHK5Reader(str(tmp_path / "rank0.chk5"))
    refs = PKGS[reader][0].resolve_shard_refs(rd, [str(tmp_path)], 0)
    rd.close()
    rd = PKGS[writer][0].CHK5Reader(str(tmp_path / "rank0.chk5"))
    ref_refs = PKGS[writer][0].resolve_shard_refs(rd, [str(tmp_path)], 0)
    rd.close()
    for name in arrays:
        assert refs[name].materialize().tobytes() == \
            ref_refs[name].materialize().tobytes()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_save_sharded_rank_files_cross_restore_elastic(tmp_path, writer,
                                                       reader):
    """Axis-0 rank files (``save_sharded``) of any world restore in the
    other package for any new world and rank."""
    arrays = {"g": np.random.default_rng(2).normal(size=(29, 5))
              .astype(np.float32),
              "m": np.arange(29, dtype=np.int64)}
    wmod, rmod = PKGS[writer][0], PKGS[reader][0]
    for old_world in (1, 3, 4):
        d = tmp_path / f"w{old_world}"
        d.mkdir()
        for r in range(old_world):
            named, offs, gshapes = {}, {}, {}
            for name, a in arrays.items():
                lo, hi = wmod.shard_bounds(a.shape[0], old_world, r)
                named[name], offs[name] = a[lo:hi], lo
                gshapes[name] = list(a.shape)
            wmod.save_sharded(str(d / f"rank{r}.chk5"), named, offs, gshapes,
                              {"world": old_world})
        for new_world in (1, 2, 3, 5):
            for new_rank in range(new_world):
                got = rmod.elastic_restore(str(d), new_world, new_rank)
                want = wmod.elastic_restore(str(d), new_world, new_rank)
                for name, a in arrays.items():
                    lo, hi = rmod.shard_bounds(a.shape[0], new_world,
                                               new_rank)
                    assert got[name].tobytes() == a[lo:hi].tobytes()
                    assert got[name].tobytes() == want[name].tobytes()


def test_save_sharded_takes_tensors():
    """The port's ``save_sharded`` writes tensor slices as their bytes."""
    import tempfile
    t = torch.arange(40, dtype=torch.bfloat16).reshape(8, 5)
    with tempfile.TemporaryDirectory() as d:
        rs.save_sharded(os.path.join(d, "rank0.chk5"), {"t": t[:8]},
                        {"t": 0}, {"t": [8, 5]})
        got = rs.elastic_restore(d, 1, 0)["t"]
    from repro_torch.core.formats import tensor_to_numpy
    assert got.tobytes() == tensor_to_numpy(t).tobytes()


def _store_shard_local(pkg, d, full, ckpt_id, step):
    """A shard-local FULL of ``w`` (4 row chunks, host data) plus a plain
    ``step`` leaf through ``pkg``'s StorageEngine, as a checkpoint context
    at ``d`` lays it out (FTI level 1)."""
    mod, _w, _p, (cfg_t, eng_t, req_t, comm_t) = PKGS[pkg]
    eng = eng_t(cfg_t(root=d, block_bytes=256),
                comm_t(os.path.join(d, "node-local")))
    plan = eng.pipeline.plan(req_t(named={"step": np.int32(step)},
                                   ckpt_id=ckpt_id, level=1))
    per = full.shape[0] // 4
    plan.sharded = {"w": mod.ShardSnapshot("<f4", full.shape, [
        mod.ShardChunk((k * per, 0), (per, full.shape[1]),
                       full[k * per:(k + 1) * per]) for k in range(4)])}
    eng.pipeline.finish(plan)
    return eng


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_shard_local_full_cross_restores(tmp_path, writer, reader):
    """A shard-local FULL built by one package's StorageEngine restores in
    the other at the same id, bit-exact; the port also restores it through
    the directives into a zeros template."""
    d = str(tmp_path / "ck")
    full = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)
    _store_shard_local(writer, d, full, 1, 7)
    _mod, _w, _p, (cfg_t, eng_t, _req, comm_t) = PKGS[reader]
    eng = eng_t(cfg_t(root=d, block_bytes=256),
                comm_t(os.path.join(d, "node-local")))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # no fall back
        named, meta = eng.load_latest()
    assert meta["id"] == 1
    assert named["w"].tobytes() == full.tobytes() and int(named["step"]) == 7
    ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                             dedicated_thread=False))
    got = ctx.load({"w": torch.zeros(16, 8),
                    "step": torch.tensor(0, dtype=torch.int32)})
    ctx.shutdown()
    assert ctx.restarted
    assert torch.equal(got["w"], torch.from_numpy(full))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7


def test_sharded_checkpoint_of_the_reference_restores_at_its_id(tmp_path):
    """The repaired fault: a checkpoint whose newest id holds ``shardidx/``
    leaves restores at that id in the port.  Before the repair the port's
    restore walk raised on the container and fell back, with only a
    warning, to the older id 1."""
    d = str(tmp_path / "ck")
    eng = RefStorageEngine(RefStorageConfig(root=d, block_bytes=256),
                           RefLocalComm(os.path.join(d, "node-local")))
    eng.store({"w": np.zeros((16, 8), np.float32), "step": np.int32(1)},
              ckpt_id=1, level=1)
    full = np.random.default_rng(4).normal(size=(16, 8)).astype(np.float32)
    _store_shard_local("repro", d, full, 2, 2)
    port = StorageEngine(StorageConfig(root=d, block_bytes=256),
                         LocalComm(os.path.join(d, "node-local")))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        named, meta = port.load_latest()
    assert meta["id"] == 2 and int(named["step"]) == 2
    assert named["w"].tobytes() == full.tobytes()
    lazy, _ = port.load_latest(lazy_sharded=True)
    assert isinstance(lazy["w"], rs.ShardedLeafRef)
    assert lazy["w"].read_index((slice(3, 11), slice(2, 5))).tobytes() == \
        full[3:11, 2:5].tobytes()
    # the serve-side loader assembles the sharded leaf onto its device
    root = port.tier_root(1)
    ck = os.path.join(root, "ckpt-2")
    onto = rs.load_named_onto(os.path.join(ck, "rank0.chk5"), [ck], 0,
                              {"w": torch.device("cpu")})
    assert torch.equal(onto["w"], torch.from_numpy(full))
    assert isinstance(onto["step"], np.ndarray)
    assert port.rank_payload(root, 2, 0) is not None
    # an incomplete shard set refuses a partial load
    os.remove(os.path.join(ck, "rank0.shard1.chk5"))
    with pytest.raises(rs.CHK5CorruptionError, match="incomplete shard set"):
        rs.load_named_onto(os.path.join(ck, "rank0.chk5"), [ck], 0, {})


def test_diff_link_over_a_sharded_base_replays(tmp_path):
    """A DIFF whose FULL base holds a sharded leaf: the walk materializes
    the base on the host and replays the delta, in both packages, and the
    port replays it on the template's device through the directives."""
    d = str(tmp_path / "ck")
    full = np.random.default_rng(5).normal(size=(16, 64)).astype(np.float32)
    _store_shard_local("repro", d, full, 1, 1)
    new = full.copy()
    new[9, 3] = -7.0
    ref = RefStorageEngine(RefStorageConfig(root=d, block_bytes=256),
                           RefLocalComm(os.path.join(d, "node-local")))
    ref.diff.update_digests_full({"w": full})        # the FULL's digests
    rep = ref.store({"w": new, "step": np.int32(2)}, ckpt_id=2, level=1,
                    kind="DIFF")
    assert rep.kind == "DIFF"
    for pkg in ("repro", "repro_torch"):
        _m, _w, _p, (cfg_t, eng_t, _r, comm_t) = PKGS[pkg]
        eng = eng_t(cfg_t(root=d, block_bytes=256),
                    comm_t(os.path.join(d, "node-local")))
        named, meta = eng.load_latest()
        assert meta["id"] == 2, pkg
        assert named["w"].tobytes() == new.tobytes(), pkg
    ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                             dedicated_thread=False,
                                             block_bytes=256))
    got = ctx.load({"w": torch.zeros(16, 64),
                    "step": torch.tensor(0, dtype=torch.int32)})
    ctx.shutdown()
    assert torch.equal(got["w"], torch.from_numpy(new))


_MESH_STORE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[2])
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.core.context import CheckpointConfig, CheckpointContext
    from repro.core.resharding import reshard_tree

    assert len(jax.devices()) == 4
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rng = np.random.default_rng(6)
    state = {"params": {
        "w": jnp.asarray(rng.normal(size=(32, 16)).astype(np.float32)),
        "e": jnp.asarray(rng.normal(size=(8, 4)).astype(np.float32)),
        "b": jnp.arange(12.0, dtype=jnp.float32)}, "step": jnp.int32(5)}
    sh = {"params": {"w": NamedSharding(mesh, P("data", "model")),
                     "e": NamedSharding(mesh, P("data")),
                     "b": NamedSharding(mesh, P())},
          "step": NamedSharding(mesh, P())}
    state = reshard_tree(state, sh)
    ctx = CheckpointContext(CheckpointConfig(
        dir=sys.argv[1], backend="fti", dedicated_thread=False))
    ctx.store({"params": {k: v * 0 for k, v in state["params"].items()},
               "step": jnp.int32(1)}, id=1, level=1)
    ctx.store(state, id=2, level=1)
    ctx.shutdown()
    np.savez(os.path.join(sys.argv[1], "want.npz"),
             w=np.asarray(state["params"]["w"]),
             e=np.asarray(state["params"]["e"]),
             b=np.asarray(state["params"]["b"]))
    print("MESH-STORE-OK")
""")


def test_named_sharding_store_of_the_reference_restores_in_the_port(
        tmp_path):
    """``repro`` stores a ``NamedSharding`` state on a forced-4-device mesh
    (Auto axes) as shard files; the port restores it bit-exact at that id
    and its ``chkls --json`` lists the shard inventory the reference's
    does."""
    d = str(tmp_path / "ck")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _MESH_STORE, d,
                        os.path.join(ROOT, "src")], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert "MESH-STORE-OK" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    want = np.load(os.path.join(d, "want.npz"))

    ctx = CheckpointContext(CheckpointConfig(dir=d, backend="fti",
                                             dedicated_thread=False))
    tmpl = {"params": {"w": torch.zeros(32, 16), "e": torch.zeros(8, 4),
                       "b": torch.zeros(12)},
            "step": torch.tensor(0, dtype=torch.int32)}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = ctx.load(tmpl)
    ctx.shutdown()
    assert ctx.restarted and int(got["step"]) == 5
    for k in ("w", "e", "b"):
        assert got["params"][k].numpy().tobytes() == want[k].tobytes(), k

    rank0 = os.path.join(d, "node-local", "ckpts", "ckpt-2", "rank0.chk5")
    from repro.tools.chkls import main as ref_chkls
    from repro_torch.tools.chkls import main as chkls
    invs = []
    for main in (chkls, ref_chkls):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([rank0, "--json"]) == 0
        invs.append(json.loads(buf.getvalue()))
    assert invs[0] == invs[1]
    by = {x["name"]: x for x in invs[0]["datasets"]}
    assert by["shardidx/params/w"]["attrs"]["n_chunks"] == 4
    assert by["shardidx/params/w"]["attrs"]["global_shape"] == [32, 16]
    assert by["shardidx/params/e"]["attrs"]["n_chunks"] == 2
    assert invs[0]["attrs"]["sharded"] is True
