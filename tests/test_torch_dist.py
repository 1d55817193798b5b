"""The port's distributed layer against the JAX package, on the CPU.

- The sharding rules (``param_shardings``, ``cache_shardings``,
  ``batch_sharding``, ``resolve_spec``) give the reference's specs leaf
  for leaf, on ``AbstractMesh`` (4, 4) and (2, 2, 4) — no devices — over
  every architecture's full-width ``param_struct``.
- The box each mesh coordinate holds (``dist.context.shard_box``) equals
  the reference's ``NamedSharding.devices_indices_map`` on (4, 4), (2, 8)
  and (2, 2, 4), run in one subprocess with 16 forced host devices.
- The hint layer is identity without a mesh, with hints disabled, and on
  a plain tensor; under a mesh it redistributes a ``DTensor``.
- ``ProcessGroupComm`` across two gloo processes: barrier, allgather,
  exchange, post/collect, and the level-2 partner tier over it (a node's
  directory wiped, the restore from its partner).
- Mirror of ``tests/test_serve_deploy_restore.py``: four processes train
  on (2, 2) and publish two level-4 FULLs to the object store; four new
  ones serve on (1, 4) behind ``FleetDeployer``, which installs v2 as
  ``DTensor`` leaves of the serving mesh after a warm v1 pull, fetching
  only the chunk delta.
- ``chip_smoke.py --device cpu --phases 13`` rehearses phase 13.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.configs import ALL_ARCHS, get_arch  # noqa: E402
from repro_torch.core.protect import Protect, flatten_named  # noqa: E402
from repro_torch.dist import context as dctx  # noqa: E402
from repro_torch.dist.context import (  # noqa: E402
    MODEL,
    AbstractMesh,
    P,
    constraint_hints,
    resolve_spec,
    shard_box,
    shard_decode_kv,
    shard_hint,
    use_mesh,
)
from repro_torch.dist.sharding import (  # noqa: E402
    batch_sharding,
    cache_shardings,
    param_shardings,
)
from repro_torch.models.zoo import build_model  # noqa: E402

MESHES = {"4x4": ((4, 4), ("data", "model")),
          "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}


def run_world(n: int, argv, timeout: float = 120, env=None):
    """``argv`` on ``n`` gloo processes (``torch.distributed.run``, a
    rendezvous store on a free port)."""
    e = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    e.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), *argv],
        cwd=ROOT, env=e, capture_output=True, text=True, timeout=timeout)


def _ref():
    import repro.core.protect as rprot
    import repro.dist.context as rctx
    import repro.dist.sharding as rsh
    from jax.sharding import AbstractMesh as RefAbstractMesh
    from repro.configs import get_arch as ref_arch
    from repro.models.zoo import build_model as ref_build
    return rprot, rctx, rsh, RefAbstractMesh, ref_arch, ref_build


def _spec(s):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in s)


# --------------------------------------------------------------------------- #
# the rules against the reference, no devices
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    rprot, _rctx, rsh, RefMesh, ref_arch, ref_build = _ref()
    shape, names = MESHES[mesh]
    struct = build_model(get_arch(arch)).param_struct()
    ref_struct = ref_build(ref_arch(arch)).param_struct()
    mine = flatten_named(param_shardings(AbstractMesh(shape, names), struct))
    ref = rprot.flatten_named(rsh.param_shardings(RefMesh(shape, names),
                                                  ref_struct))[0]
    assert list(mine) == list(ref)
    leaves, ref_leaves = flatten_named(struct), rprot.flatten_named(
        ref_struct)[0]
    for path in ref:
        assert tuple(leaves[path].shape) == tuple(ref_leaves[path].shape)
        assert str(leaves[path].dtype).split(".")[-1] == \
            str(ref_leaves[path].dtype), path
        assert leaves[path].device.type == "meta"
        assert _spec(mine[path].spec) == _spec(ref[path].spec), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "minicpm3-4b",
                                  "rwkv6-3b", "jamba-1.5-large-398b",
                                  "whisper-small"])
def test_cache_and_batch_specs_equal_reference(arch, mesh):
    rprot, _rctx, rsh, RefMesh, ref_arch, ref_build = _ref()
    shape, names = MESHES[mesh]
    m, rm = build_model(get_arch(arch)), ref_build(ref_arch(arch))
    for batch in (8, 4, 1):
        caches, ref_caches = m.cache_struct(batch, 64), rm.cache_struct(
            batch, 64)
        for seq in (False, True):
            for protects in (True, False):
                mine = flatten_named(cache_shardings(
                    AbstractMesh(shape, names), caches, batch,
                    seq_axis_sharded=seq,
                    protects=m.cache_protects() if protects else None))
                ref = rprot.flatten_named(rsh.cache_shardings(
                    RefMesh(shape, names), ref_caches, batch,
                    seq_axis_sharded=seq,
                    protects=rm.cache_protects() if protects else None))[0]
                assert list(mine) == list(ref)
                for path in ref:
                    assert _spec(mine[path].spec) == _spec(ref[path].spec), \
                        (batch, seq, protects, path)
    for ndim in (1, 2, 3):
        for divisible in (True, False):
            assert _spec(batch_sharding(AbstractMesh(shape, names), ndim,
                                        batch_divisible=divisible).spec) == \
                _spec(rsh.batch_sharding(RefMesh(shape, names), ndim,
                                         batch_divisible=divisible).spec)


def test_resolve_spec_equals_reference():
    _rprot, rctx, _rsh, RefMesh, _a, _b = _ref()
    cases = [((None, MODEL), (64, 48)), ((MODEL, None), (6, 48)),
             (("data", MODEL), (8, 8)), (("data",), (3,)),
             ((("pod", "data"), None), (8, 2)), (("absent", MODEL), (4, 4)),
             ((None, None), (4, 4)), ((MODEL,), (4, 4, 4))]
    for shape, names in MESHES.values():
        for axes, dims in cases:
            mine = resolve_spec(AbstractMesh(shape, names), axes, dims)
            ref = rctx.resolve_spec(RefMesh(shape, names), axes, dims)
            assert (mine is None) == (ref is None), (axes, dims)
            if ref is not None:
                assert _spec(mine) == _spec(ref), (axes, dims)


def test_cache_shardings_takes_protect_metadata_first():
    """Two stacked layers and a batch of 2: the size heuristic takes the
    layer dim for the batch; the Protect axis clause pins dim 1."""
    mesh = AbstractMesh((2, 2), ("data", "model"))
    caches = {"k": torch.empty((2, 2, 8, 4, 16), device="meta")}
    assert cache_shardings(mesh, caches, 2)["k"].spec == \
        P("data", None, MODEL, None, None)
    assert cache_shardings(mesh, caches, 2, protects=[
        Protect("k", axis={"batch": 1})])["k"].spec == \
        P(None, "data", None, MODEL, None)


# --------------------------------------------------------------------------- #
# boxes against the reference's devices_indices_map (16 forced devices)
# --------------------------------------------------------------------------- #

_BOX_MESHES = {"4x4": ((4, 4), ("data", "model")),
               "2x8": ((2, 8), ("data", "model")),
               "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}

_REF_BOXES = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import jax
    import numpy as np
    from jax.sharding import AxisType
    sys.path.insert(0, "src")
    from repro.configs import get_arch
    from repro.core.protect import flatten_named
    from repro.dist.sharding import cache_shardings, param_shardings
    from repro.models.zoo import build_model

    m = build_model(get_arch("tinyllama-1.1b"))
    trees = {"params": m.param_struct(), "caches": m.cache_struct(8, 64)}
    out = {}
    for key, (shape, names) in json.loads(sys.argv[1]).items():
        mesh = jax.make_mesh(tuple(shape), tuple(names),
                             axis_types=(AxisType.Auto,) * len(shape))
        shard = {"params": param_shardings(mesh, trees["params"]),
                 "caches": cache_shardings(mesh, trees["caches"], 8,
                                           protects=m.cache_protects())}
        got = {}
        for t, tree in trees.items():
            leaves = flatten_named(tree)[0]
            sh = flatten_named(shard[t])[0]
            for p, leaf in leaves.items():
                imap = sh[p].devices_indices_map(tuple(leaf.shape))
                got[t + "/" + p] = {
                    "spec": [list(e) if isinstance(e, tuple) else e
                             for e in sh[p].spec],
                    "boxes": [[[0 if s.start is None else s.start,
                                d if s.stop is None else s.stop]
                               for s, d in zip(imap[mesh.devices[c]],
                                               leaf.shape)]
                              for c in np.ndindex(*shape)]}
        out[key] = got
    print("BOXES " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_boxes():
    r = subprocess.run([sys.executable, "-c", _REF_BOXES,
                        json.dumps(_BOX_MESHES)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    line = [x for x in r.stdout.splitlines() if x.startswith("BOXES ")]
    assert line, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(line[0][len("BOXES "):])


@pytest.mark.parametrize("mesh", sorted(_BOX_MESHES))
def test_boxes_equal_reference_devices_indices_map(ref_boxes, mesh):
    """Per mesh coordinate, the port's box of every parameter and cache
    leaf of tinyllama-1.1b equals the reference's: a dim split over
    ``("pod", "data")`` (the caches' batch on 2×2×4) included."""
    shape, names = _BOX_MESHES[mesh]
    am = AbstractMesh(shape, names)
    m = build_model(get_arch("tinyllama-1.1b"))
    trees = {"params": (m.param_struct(), None),
             "caches": (m.cache_struct(8, 64), m.cache_protects())}
    split_twice = 0
    for t, (tree, protects) in trees.items():
        sh = flatten_named(param_shardings(am, tree) if t == "params" else
                           cache_shardings(am, tree, 8, protects=protects))
        for p, leaf in flatten_named(tree).items():
            want = ref_boxes[mesh][f"{t}/{p}"]
            spec = sh[p].spec
            assert [list(e) if isinstance(e, tuple) else e
                    for e in spec] == want["spec"], p
            split_twice += any(isinstance(e, tuple) for e in spec)
            got = [[list(b) for b in shard_box(tuple(leaf.shape), am, spec,
                                                c)]
                   for c in np.ndindex(*shape)]
            assert got == want["boxes"], (mesh, t, p)
    assert split_twice == (2 if mesh == "2x2x4" else 0)     # k and v


# --------------------------------------------------------------------------- #
# the hint layer
# --------------------------------------------------------------------------- #


def test_hints_are_identity_without_mesh_disabled_or_on_plain_tensors():
    x = torch.randn(8, 4, 2, 16)
    assert dctx.active_mesh() is None
    assert shard_hint(x, "data", None, MODEL) is x
    assert shard_decode_kv(x) is x
    mesh = AbstractMesh((2, 2), ("data", "model"))
    with use_mesh(mesh):
        assert dctx.active_mesh() is mesh
        with constraint_hints(False):
            assert not dctx.hints_enabled()
            assert shard_hint(x, "data") is x
            assert shard_decode_kv(x) is x
        # a plain tensor carries no layout: unchanged under a mesh too
        assert shard_hint(x, "data", None, MODEL) is x
        assert shard_decode_kv(x) is x
    assert dctx.active_mesh() is None and dctx.hints_enabled()


# --------------------------------------------------------------------------- #
# two gloo processes: the communicator, the partner tier, DTensor hints
# --------------------------------------------------------------------------- #


def _comm_worker(out_dir: str) -> None:
    import shutil

    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.resharding import reshard_tree
    from repro_torch.dist.comm import ProcessGroupComm
    from repro_torch.dist.context import NamedSharding
    from repro_torch.launch.mesh import join_from_env, leave, make_mesh

    rank, world, _device, _ = join_from_env("cpu")
    comm = ProcessGroupComm(os.path.join(out_dir, "ck", "nodes"))
    res = {"rank": rank, "world": comm.world}
    comm.barrier()
    res["allgather"] = comm.allgather({"rank": rank})
    res["exchange"] = comm.exchange([rank] * (rank + 1))
    comm.post("t", (rank + 1) % world, f"from{rank}".encode())
    comm.barrier()
    res["collect"] = comm.collect("t", (rank - 1) % world).decode()
    res["collect_again"] = comm.collect("t", (rank - 1) % world)
    res["peer"] = comm.peer_local_dir((rank + 1) % world)

    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    d = reshard_tree({"x": x}, {"x": NamedSharding(mesh, P(MODEL, None))})[
        "x"]
    with use_mesh(mesh):
        y = shard_hint(d, None, MODEL)
        kv = shard_decode_kv(reshard_tree(
            {"k": torch.arange(2 * 4 * 2 * 3.0).reshape(2, 4, 2, 3)},
            {"k": NamedSharding(mesh, P())})["k"])
        with constraint_hints(False):
            res["hint_off_same"] = shard_hint(d, None, MODEL) is d
    # the global view on the host, two ways: gather_tree, and Plan's
    # gathered snapshot (sharded snapshots off) through the exchange
    from repro_torch.core.resharding import gather_tree, split_sharded
    res["gather_tree"] = bool(np.array_equal(gather_tree({"x": d})["x"],
                                             x.numpy()))
    host, shards = split_sharded({"x": d}, enabled=False,
                                 gather=comm.exchange)
    res["gathered_snapshot"] = not shards and bool(
        np.array_equal(host["x"], x.numpy()))
    res["hint_placements"] = [repr(p) for p in y.placements]
    res["hint_equal"] = bool(torch.equal(y.full_tensor(), x))
    res["kv_placements"] = [repr(p) for p in kv.placements]

    # the level-2 partner tier over the communicator
    state = {"w": torch.arange(300, dtype=torch.float32) + rank,
             "step": torch.tensor(7 + rank)}
    cfg = CheckpointConfig(dir=os.path.join(out_dir, "ck"), objstore=False,
                           dedicated_thread=False)
    ctx = CheckpointContext(cfg, comm)
    ctx.store(state, id=1, level=2)
    ctx.shutdown()
    comm.barrier()
    if rank == 1:                   # node loss: its storage is gone
        shutil.rmtree(comm.node_local_dir)
        os.makedirs(comm.node_local_dir)
    comm.barrier()
    ctx = CheckpointContext(cfg, comm)
    got = ctx.load({"w": torch.zeros(300), "step": torch.tensor(0)})
    ctx.shutdown()
    res["partner_restored"] = ctx.restarted and bool(
        torch.equal(got["w"], state["w"])) and int(got["step"]) == 7 + rank
    with open(os.path.join(out_dir, f"comm-rank{rank}.json"), "w") as f:
        json.dump(res, f)
    leave()


@pytest.fixture(scope="module")
def comm_world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("comm"))
    r = run_world(2, [__file__, "comm", d])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return d, [json.load(open(os.path.join(d, f"comm-rank{i}.json")))
               for i in range(2)]


def test_communicator_collectives_and_mail_across_two_processes(comm_world):
    d, res = comm_world
    for r in res:
        assert r["world"] == 2
        assert r["allgather"] == [{"rank": 0}, {"rank": 1}]
        assert r["exchange"] == [[0], [1, 1]]
        assert r["collect"] == f"from{1 - r['rank']}"
        assert r["collect_again"] is None          # a post is read once
        assert r["peer"] == os.path.join(d, "ck", "nodes",
                                         f"rank{1 - r['rank']}")


def test_partner_tier_restores_a_wiped_node_over_the_communicator(
        comm_world):
    d, res = comm_world
    assert all(r["partner_restored"] for r in res)
    # rank 1's own container is gone; rank 0's dir holds its partner copy
    ck = os.path.join(d, "ck", "nodes", "rank0", "ckpts", "ckpt-1")
    assert "rank0.partner1.chk5" in os.listdir(ck)


def test_make_host_mesh_joins_a_one_process_world():
    out = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.launch.mesh import make_host_mesh, leave; "
         "m = make_host_mesh(); "
         "print(m.mesh_dim_names, tuple(m.mesh.shape), "
         "list(m.get_coordinate())); "
         "leave()"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "('data', 'model') (1, 1) [0, 0]"


def test_hints_redistribute_a_dtensor_under_a_mesh(comm_world):
    _d, res = comm_world
    for r in res:
        assert r["hint_placements"] == ["Replicate()", "Shard(dim=1)"]
        assert r["hint_equal"] and r["hint_off_same"]
        assert r["gather_tree"] and r["gathered_snapshot"]
        # the batch (dim 0) on the one-rank data axis, the heads (dim 2)
        # on model
        assert r["kv_placements"] == ["Shard(dim=0)", "Shard(dim=2)"]


def test_chip_smoke_rehearses_phase_13_on_cpu(tmp_path):
    """``chip_smoke.py --device cpu --phases 13``: phase 13 on four gloo
    processes at the reduced config (store on (2, 2), restores onto (1, 4)
    and (2, 1), exact dirty count, own boxes only); no result printed."""
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--device", "cpu", "--phases", "13",
         "--block-bytes", "256", "--workdir", str(tmp_path)], cwd=ROOT,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "as counted from the rows the update wrote" in out.stdout
    assert "restore onto (1,4) on 4 processes" in out.stdout
    assert "restore onto (2,1) on 2 processes" in out.stdout
    assert '"ok"' not in out.stdout


def test_decode_hold_measures_shift_free_kl_and_dtype_spacing():
    """Phase 13's decode hold: ``kl_div`` is 0 for equal rows and for rows
    that differ by a constant (a softmax ignores a shared offset) and
    grows with a change of the row's shape; ``_ulp`` is the dtype's
    spacing at a value (bf16 4 at 550, the sparse update's logits)."""
    from repro_torch.launch.meshckpt import _ulp, kl_div
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 1, 64))
                         ).float()
    assert kl_div(x, x) == 0.0
    assert abs(kl_div(x, x + 550.0)) < 1e-9
    small, large = kl_div(x, x * 1.01), kl_div(x, x * 2.0)
    assert 0.0 < small < large
    assert _ulp(550.0, torch.bfloat16) == 4.0
    assert _ulp(-3.0, torch.bfloat16) == 2.0 ** -6
    assert _ulp(1.0, torch.float32) == 2.0 ** -23
    assert _ulp(0.0, torch.float32) > 0.0


# --------------------------------------------------------------------------- #
# deploy: train on (2, 2), serve on (1, 4)
# --------------------------------------------------------------------------- #


def _deploy_state(tuned: bool):
    """``w`` small and retuned between v1 and v2, ``c`` large and
    untouched: the publish's chunk delta is ``w``'s bytes."""
    rng = np.random.default_rng(0)
    w = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    c = rng.normal(size=(256, 256)).astype(np.float32)
    if tuned:
        w = w * 1.25 + 3.0
    return {"params": {"w": torch.from_numpy(w), "c": torch.from_numpy(c)},
            "step": torch.tensor(2 if tuned else 1, dtype=torch.int32)}


def _deploy_worker(mode: str, d: str) -> None:
    from types import SimpleNamespace

    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.resharding import reshard_tree, zeros_onto
    from repro_torch.dist.comm import ProcessGroupComm
    from repro_torch.dist.context import NamedSharding
    from repro_torch.launch.mesh import join_from_env, leave, make_mesh
    from repro_torch.objstore.client import make_object_store
    from repro_torch.objstore.inspect import CatalogView
    from repro_torch.serve.deploy import FleetDeployer, Replica
    from repro_torch.serve.engine import ServingEngine, WeightsHandle

    rank, _world, _device, _ = join_from_env("cpu")
    mesh = make_mesh((2, 2) if mode == "train" else (1, 4), ("data", "model"),
                     "cpu")
    sh = {"w": NamedSharding(mesh, P("data", MODEL)),
          "c": NamedSharding(mesh, P("data", MODEL))}
    res = {"rank": rank}
    if mode == "train":
        comm = ProcessGroupComm(os.path.join(d, "nodes"))
        ctx = CheckpointContext(CheckpointConfig(
            dir=d, backend="fti", dedicated_thread=False,
            objstore_cdc_min_bytes=512, objstore_cdc_avg_bytes=2048,
            objstore_cdc_max_bytes=8192), comm)
        for cid, tuned in ((1, False), (2, True)):
            st = _deploy_state(tuned)
            st["params"] = reshard_tree(st["params"], sh)
            ctx.store(st, id=cid, level=4)
        ctx.shutdown()
        view = CatalogView.from_root(os.path.join(d, "objstore"))
        e1, e2 = view.entry(1), view.entry(2)
        res.update(ids=view.ids(), kinds=[e1.kind, e2.kind],
                   predicted=CatalogView.diff(e1, e2).ratio)
    else:
        store = make_object_store("file:" + os.path.join(d, "objstore"))
        template = zeros_onto({"w": torch.empty(64, 64, device="meta"),
                               "c": torch.empty(256, 256, device="meta")},
                              sh)
        model = SimpleNamespace(
            cfg=SimpleNamespace(compute_dtype="float32"),
            decode_step=lambda p, tok, caches, pos: (tok.float()[:, :, None],
                                                     caches))
        eng = ServingEngine(model, WeightsHandle(params=template), batch=2,
                            max_len=8)
        rep = Replica(name=f"serve{rank}", engine=eng, rank=rank,
                      cache_root=os.path.join(d, f"serve-cache{rank}"),
                      prefix="params")
        view = CatalogView.from_store(store)
        rep.puller(store).pull(view.entry(1))      # v1 deployed: warm cache
        dep = FleetDeployer(store, [rep])
        res["last"] = dep.run_until_converged()
        fetched, cached = dep.stats["bytes_fetched"], dep.stats["bytes_cached"]
        res.update(entry=eng.weights.entry_id, fetched=fetched, cached=cached,
                   predicted=CatalogView.diff(view.entry(1),
                                              view.entry(2)).ratio)
        want = _deploy_state(True)["params"]
        got = eng.params
        res["exact"] = all(
            torch.equal(got[k].to_local(), want[k][
                tuple(slice(lo, hi) for lo, hi in shard_box(
                    (want[k].shape), mesh, sh[k].spec,
                    mesh.get_coordinate()))])
            for k in want)
        res["placements"] = all(got[k].placements == sh[k].placements
                                for k in want)
    with open(os.path.join(d, f"deploy-{mode}-rank{rank}.json"), "w") as f:
        json.dump(res, f)
    leave()


def test_deploy_from_a_2x2_training_mesh_onto_a_1x4_serving_mesh(tmp_path):
    d = str(tmp_path)
    for mode in ("train", "serve"):
        r = run_world(4, [__file__, "deploy-" + mode, d], timeout=180)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    train = json.load(open(os.path.join(d, "deploy-train-rank0.json")))
    assert train["ids"] == [1, 2] and train["kinds"] == ["FULL", "FULL"]
    assert 0 < train["predicted"] < 0.30
    for r in range(4):
        got = json.load(open(os.path.join(d, f"deploy-serve-rank{r}.json")))
        assert got["last"] == {"action": "converged", "entry": 2}
        assert got["entry"] == 2 and got["exact"] and got["placements"]
        measured = got["fetched"] / float(got["fetched"] + got["cached"])
        assert got["cached"] > 0 and measured < 0.30, got
        assert abs(measured - got["predicted"]) < 0.10, (measured, got)


if __name__ == "__main__":
    if sys.argv[1] == "comm":
        _comm_worker(sys.argv[2])
    elif sys.argv[1].startswith("deploy-"):
        _deploy_worker(sys.argv[1][len("deploy-"):], sys.argv[2])
