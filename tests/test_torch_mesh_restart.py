"""Mesh-change restart on the port, mirroring ``tests/test_mesh_restart.py``
at smaller worlds: gloo processes on the CPU (``torch.distributed.run``),
reduced tinyllama-1.1b placed by the sharding rules as ``DTensor`` leaves.

A 4-process world on a (2, 2) mesh stores a FULL and then, after
``embed[0, 0] = -3``, a DIFF (FTI; SCR and VeloC store a second FULL).
Each rank writes the box it owns (the lowest rank of the ranks holding a
box) into its own shard files and indexes every owner's chunks.  The
checkpoint restores into zero ``DTensor`` templates on (1, 4) and (4, 1)
in four processes and on (2, 1) in two, every rank's local values
bit-exact with the source's box (SHA-256 per box intersection), the
template's placements kept.

Cross-reading: the reference restores the port's ``rank0.chk5`` (with
the files it names) onto an Auto (4, 1) mesh, and the port restores the
reference's Auto (2, 2) store onto (1, 4); both packages' ``chkls --json``
of ``rank0.chk5`` agree.  Mirrors of ``tests/test_sharded_store.py``: Plan
snapshots each rank's own box and gathers no sharded leaf; a hard kill
after two shard files leaves ``ckpt-2.tmp`` behind and the restore falls
back to id 1; the shard inventory is right.
"""
import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.launch.meshckpt import compare  # noqa: E402

BB = "256"                       # hash block bytes at the reduced widths
WORKER = ["-m", "repro_torch.launch.meshckpt"]
COMMON = ["--reduced", "--device", "cpu", "--block-bytes", BB]


def _world_cmd(n: int, argv):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n), *argv]


def _env(extra=None):
    e = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    e.update(extra or {})
    return e


def run_world(n: int, argv, timeout: float = 180, env=None):
    """``argv`` on ``n`` gloo processes (``torch.distributed.run``, a
    rendezvous store on a free port)."""
    return subprocess.run(_world_cmd(n, argv), cwd=ROOT, env=_env(env),
                          capture_output=True, text=True, timeout=timeout)


def run_worlds(worlds, timeout: float = 240):
    """Several ``(n, argv)`` worlds at once → their results, in order."""
    procs = [subprocess.Popen(_world_cmd(n, argv), cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for n, argv in worlds]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=timeout)
        out.append(subprocess.CompletedProcess(p.args, p.returncode, stdout,
                                               stderr))
    return out


def _ok(r):
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]


def _load(out: str, name: str):
    files = sorted(glob.glob(os.path.join(out, f"{name}-rank*.json")),
                   key=lambda f: int(f.rsplit("rank", 1)[1][:-5]))
    return [json.load(open(f)) for f in files]


def _store_argv(d: str, backend: str, extra=()):
    return WORKER + ["store", *COMMON, "--mesh", "2,2",
                     "--dir", os.path.join(d, "ck"),
                     "--out", os.path.join(d, "out"), "--backend", backend,
                     "--update", "embed00", "--targets", "1,4;4,1;2,1",
                     "--hash-after", "1,2", *extra]


def _store(d: str, backend: str, extra=()):
    return run_world(4, _store_argv(d, backend, extra)), os.path.join(d, "out")


BACKENDS = ("fti", "scr", "veloc")
_WORLDS = {}


def _worlds(tmp_path_factory):
    """Per backend, at once: store on (2, 2) and restore on (1, 4) and
    (4, 1) in the same four processes; then, at once, restore on (2, 1) in
    two new ones."""
    if not _WORLDS:
        dirs = {b: str(tmp_path_factory.mktemp(b)) for b in BACKENDS}
        for r in run_worlds([(4, _store_argv(dirs[b], b, [
                "--then-restore", "1,4;4,1"])) for b in BACKENDS]):
            _ok(r)
        for r in run_worlds([(2, WORKER + [
                "restore", *COMMON, "--mesh", "2,1", "--source-mesh", "2,2",
                "--dir", os.path.join(dirs[b], "ck"),
                "--out", os.path.join(dirs[b], "out"), "--backend", b])
                for b in BACKENDS]):
            _ok(r)
        _WORLDS.update({b: (b, dirs[b], os.path.join(dirs[b], "out"))
                        for b in BACKENDS})
    return _WORLDS


@pytest.fixture(scope="module", params=BACKENDS)
def stored(request, tmp_path_factory):
    return _worlds(tmp_path_factory)[request.param]


@pytest.fixture(scope="module", params=["fti", "veloc"])
def piped(request, tmp_path_factory):
    """The backends whose stores run the pipeline's Plan."""
    return _worlds(tmp_path_factory)[request.param]


@pytest.fixture(scope="module")
def fti(tmp_path_factory):
    return _worlds(tmp_path_factory)["fti"]


@pytest.mark.parametrize("mesh,world", [("1x4", 4), ("4x1", 4),
                                        ("2x1", 2)])
def test_restore_onto_another_mesh_is_bit_exact(stored, mesh, world):
    backend, _d, out = stored
    src, got = _load(out, "store"), _load(out, f"restore-{mesh}")
    assert len(src) == 4 and len(got) == world
    assert [s["kind"] for s in src[0]["stores"]] == \
        ["FULL", "DIFF" if backend == "fti" else "FULL"]
    assert all(g["restarted"] and g["placements_kept"] for g in got)
    assert compare(src, got) > 0
    # the source changed between the stores (embed[0, 0] = -3) and the
    # restore holds the second store's values
    before = {k: v for r in src for k, v in r["hashes_1"].items()}
    after = {k: v for r in src for k, v in r["hashes_2"].items()}
    assert [k for k in after if after[k] != before[k]] == \
        [k for k in after if k.startswith("embed|[[0, ")
         and after[k] != before[k]] != []


def test_plan_snapshots_each_ranks_own_box_and_gathers_no_sharded_leaf(
        piped):
    backend, _d, out = piped
    src = _load(out, "store")
    for s in src:
        inv = s["stores"][0]["inventory"]
        assert not set(inv["host"]) & set(s["shardable"])
        assert set(inv["boxes"]) == set(s["shardable"])
        for path, chunks in inv["boxes"].items():
            # (data, model) = (rank // 2, rank % 2): ranks 2 and 3 hold the
            # boxes of ranks 0 and 1, so they write none
            assert len(chunks) == (1 if s["rank"] < 2 else 0), path
    # the DIFF container holds the one dirty block of embed on every rank
    if backend == "fti":
        assert [s["dirty_blocks"] for s in src] == [1] * 4


def _chkls(path: str):
    from repro.tools.chkls import main as ref_chkls
    from repro_torch.tools.chkls import main as chkls
    invs = []
    for main in (chkls, ref_chkls):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([path, "--json"]) == 0
        invs.append(json.loads(buf.getvalue()))
    return invs


def test_rank0_container_indexes_every_owners_chunks(stored):
    """``chkls --json`` of ``rank0.chk5``: both packages' tools agree, and
    a leaf sharded on model lists two chunks, one in each owner's files
    (the data-axis duplicates are gone)."""
    backend, d, _out = stored
    ck = os.path.join(d, "ck", "nodes")
    for cid in (1, 2):
        path = os.path.join(ck, "rank0", "ckpts", f"ckpt-{cid}", "rank0.chk5")
        mine, ref = _chkls(path)
        assert mine == ref
        if cid == 2 and backend == "fti":
            continue                    # a DIFF container holds deltas
        by = {x["name"]: x["attrs"] for x in mine["datasets"]}
        idx = by["shardidx/groups/0/attn/wq"]
        assert idx["n_chunks"] == 2
        assert [f.split(".")[0] for f in idx["files"]] == ["rank0", "rank1"]
        assert mine["attrs"]["sharded"] is True
        for f in idx["files"]:
            r = f.split(".")[0]
            assert os.path.exists(os.path.join(ck, r, "ckpts",
                                               f"ckpt-{cid}", f))


# --------------------------------------------------------------------------- #
# cross-reading with the reference
# --------------------------------------------------------------------------- #

_REF_RESTORE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    sys.path.insert(0, "src")
    from repro.configs import get_arch
    from repro.core.comm import LocalComm
    from repro.core.context import CheckpointConfig, CheckpointContext
    from repro.core.protect import flatten_named
    from repro.core.resharding import gather_tree, reshard_tree
    from repro.dist.sharding import param_shardings
    from repro.models.zoo import build_model

    d, out = sys.argv[1], sys.argv[2]
    m = build_model(get_arch("tinyllama-1.1b").reduced())
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    sh = param_shardings(mesh, m.param_struct())
    template = reshard_tree(jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), m.param_struct()), sh)
    ctx = CheckpointContext(CheckpointConfig(
        dir=d, backend="fti", dedicated_thread=False, objstore=False),
        comm=LocalComm(os.path.join(d, "nodes", "rank0")))
    got = ctx.load(template)
    assert ctx.restarted
    ctx.shutdown()
    g, s = flatten_named(got)[0], flatten_named(sh)[0]
    assert all(g[p].sharding == s[p] for p in s)
    np.savez(out, **{p.replace("/", "|"): v for p, v in
                     flatten_named(gather_tree(got))[0].items()})
    print("REF-RESTORE-OK")
""")

_REF_STORE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import AxisType
    sys.path.insert(0, "src")
    from repro.configs import get_arch
    from repro.core.comm import LocalComm
    from repro.core.context import (CHK_DIFF, CheckpointConfig,
                                    CheckpointContext)
    from repro.core.protect import flatten_named
    from repro.core.resharding import gather_tree, reshard_tree
    from repro.dist.sharding import param_shardings
    from repro.models.zoo import build_model

    d, out = sys.argv[1], sys.argv[2]
    m = build_model(get_arch("tinyllama-1.1b").reduced())
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    params = reshard_tree(m.init(jax.random.PRNGKey(3)),
                          param_shardings(mesh, m.param_struct()))
    ctx = CheckpointContext(CheckpointConfig(
        dir=d, backend="fti", dedicated_thread=False, block_bytes=256,
        objstore=False), comm=LocalComm(os.path.join(d, "nodes", "rank0")))
    ctx.store(params, id=1, level=1)
    params = dict(params, embed=params["embed"].at[0, 0].set(-3.0))
    ctx.store(params, id=2, level=1, kind=CHK_DIFF)
    ctx.shutdown()
    np.savez(out, **{p.replace("/", "|"): v for p, v in
                     flatten_named(gather_tree(params))[0].items()})
    print("REF-STORE-OK")
""")


def _ref(script: str, *argv):
    r = subprocess.run([sys.executable, "-c", script, *argv], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r


def _global_hashes(arrays, keys):
    """SHA-256 of the global arrays' values on each ``"leaf|box"`` key."""
    import hashlib
    out = {}
    for key in keys:
        leaf, box = key.split("|", 1)
        a = arrays[leaf.replace("/", "|")]
        sl = tuple(slice(lo, hi) for lo, hi in json.loads(box))
        out[key] = hashlib.sha256(
            np.ascontiguousarray(a[sl]).tobytes()).hexdigest()
    return out


def test_reference_restores_the_ports_store_on_an_auto_4x1_mesh(
        fti, tmp_path):
    """``rank0.chk5`` with the files it names, copied out of the four
    ranks' node-local dirs, is a complete checkpoint for the reference's
    one-process walk (FULL + DIFF on FTI)."""
    _backend, d, out = fti
    view = tmp_path / "view"
    ck = os.path.join(d, "ck", "nodes")
    for cid in (1, 2):
        dst = view / "nodes" / "rank0" / "ckpts" / f"ckpt-{cid}"
        dst.mkdir(parents=True)
        src = os.path.join(ck, "rank0", "ckpts", f"ckpt-{cid}")
        for f in ("rank0.chk5", "manifest.json"):
            shutil.copy(os.path.join(src, f), dst / f)
        for f in glob.glob(os.path.join(ck, "rank*", "ckpts", f"ckpt-{cid}",
                                        "rank*.shard*.chk5")):
            shutil.copy(f, dst / os.path.basename(f))
    want = str(tmp_path / "got.npz")
    _ref(_REF_RESTORE, str(view), want)
    arrays = np.load(want)
    src = _load(out, "store")
    source = {k: v for s in src for k, v in s["hashes_2"].items()}
    assert source and _global_hashes(arrays, source) == source
    assert float(arrays["embed"][0, 0]) == -3.0


def test_port_restores_the_references_auto_2x2_store_on_1x4(tmp_path):
    d = str(tmp_path / "ck")
    want = str(tmp_path / "want.npz")
    r = _ref(_REF_STORE, d, want)
    assert "REF-STORE-OK" in r.stdout
    out = str(tmp_path / "out")
    _ok(run_world(4, WORKER + ["restore", *COMMON, "--mesh", "1,4",
                               "--source-mesh", "2,2", "--dir", d,
                               "--out", out]))
    got = _load(out, "restore-1x4")
    assert len(got) == 4
    assert all(g["restarted"] and g["placements_kept"] for g in got)
    arrays = np.load(want)
    for g in got:
        assert g["hashes"] == _global_hashes(arrays, g["hashes"])
    assert float(arrays["embed"][0, 0]) == -3.0


def test_two_processes_restore_boxes_four_owners_wrote(tmp_path):
    """Stored from (1, 4), every rank writes a box into its own node-local
    dir; a world of two restores onto (2, 1) and finds the boxes of
    ranks 2 and 3 in their dirs (the communicator's ``peer_ranks``)."""
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    _ok(run_world(4, WORKER + ["store", *COMMON, "--mesh", "1,4",
                               "--dir", ck, "--out", out,
                               "--targets", "2,1"]))
    owners = {s["rank"] for s in _load(out, "store")
              if any(s["stores"][0]["inventory"]["boxes"].values())}
    assert owners == {0, 1, 2, 3}
    _ok(run_world(2, WORKER + ["restore", *COMMON, "--mesh", "2,1",
                               "--source-mesh", "1,4", "--dir", ck,
                               "--out", out]))
    got = _load(out, "restore-2x1")
    assert all(g["restarted"] and g["placements_kept"] for g in got)
    assert compare(_load(out, "store"), got) > 0


# --------------------------------------------------------------------------- #
# a hard kill mid-store
# --------------------------------------------------------------------------- #


def test_kill_after_two_shard_files_falls_back_to_the_older_id(tmp_path):
    d = str(tmp_path)
    kill = json.dumps([{"site": "shard.file", "mode": "exit", "at": 2,
                        "match": {"stage": "ckpt-2.tmp"}}])
    out = os.path.join(d, "out")
    r = run_world(4, WORKER + ["store", *COMMON, "--mesh", "2,2",
                               "--dir", os.path.join(d, "ck"), "--out", out,
                               "--update", "embed00", "--second", "full",
                               "--targets", "1,4", "--hash-after", "1"],
                  env={"OPENCHK_CHAOS": kill})
    assert r.returncode != 0
    local = os.path.join(d, "ck", "nodes", "rank0", "ckpts")
    assert os.path.isdir(os.path.join(local, "ckpt-2.tmp"))
    assert not os.path.isdir(os.path.join(local, "ckpt-2"))
    assert len(glob.glob(os.path.join(local, "ckpt-2.tmp",
                                      "rank0.shard*.chk5"))) >= 2
    _ok(run_world(4, WORKER + ["restore", *COMMON, "--mesh", "1,4",
                               "--source-mesh", "2,2",
                               "--dir", os.path.join(d, "ck"),
                               "--out", out]))
    got = _load(out, "restore-1x4")
    assert all(g["restarted"] for g in got)
    assert compare(_load(out, "store"), got, after=1) > 0


# --------------------------------------------------------------------------- #
# the object store alone
# --------------------------------------------------------------------------- #


def test_objstore_sharded_store_wipe_then_restore_onto_another_mesh(
        tmp_path):
    """Mirror of ``tests/test_objstore_restore.py``: a level-4 store from
    (2, 2) (the global tier's directory committed by rank 0, every rank's
    files uploaded to the object store, FULL + DIFF), then the node-local
    and global directories wiped; four new processes find the checkpoint
    in the catalog, fetch each container with the shard files its index
    names, and restore onto (1, 4) bit-exact."""
    d = str(tmp_path)
    r, out = _store(d, "fti", ["--level", "4", "--objstore"])
    _ok(r)
    ck = os.path.join(d, "ck")
    assert os.path.isdir(os.path.join(ck, "global", "ckpt-2"))
    for sub in ("nodes", "global"):
        shutil.rmtree(os.path.join(ck, sub))
    _ok(run_world(4, WORKER + ["restore", *COMMON, "--mesh", "1,4",
                               "--source-mesh", "2,2", "--dir", ck,
                               "--out", out, "--objstore"]))
    got = _load(out, "restore-1x4")
    assert all(g["restarted"] and g["placements_kept"] for g in got)
    assert compare(_load(out, "store"), got) > 0
