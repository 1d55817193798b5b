"""The port stands alone: ``repro_torch`` imports neither jax nor any module
of the JAX package ``repro``, and its main paths (directives, training,
a reduced MoE model's forward and donated step, serving and deploy, a
reduced MLA model's decode step, served and its state stored, a reduced
RWKV6 model's decode over its recurrent state, served and its state
stored, a reduced whisper-small's forward and decode step, a chaos scenario
cell and an elastic restore; a shard-local store from a two-process
mesh and its restore onto another mesh) run with jax absent — as
``chip_smoke.py`` drives them, which also refuses to run without a
card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_SCRIPT = r"""
import sys, tempfile
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import torch
from repro_torch.core.context import (CHK_DIFF, CheckpointConfig,
                                      CheckpointContext)
d = tempfile.mkdtemp()
cfg = CheckpointConfig(dir=d, backend="fti", block_bytes=256, objstore=False)
x = torch.arange(4096, dtype=torch.float32)
ctx = CheckpointContext(cfg)
ctx.store({"x": x}, id=1, level=1)
x[17] = -1.0
ctx.store({"x": x}, id=2, level=1, kind=CHK_DIFF)
ctx.shutdown()
ctx2 = CheckpointContext(cfg)
got = ctx2.load({"x": torch.zeros(4096)})
ctx2.shutdown()
assert ctx2.restarted and torch.equal(got["x"], x)

# level 4 with the object-store rung (the default): FULL, DIFF, then a
# restore from the object store alone, the DIFF replayed onto the template
import glob, os, shutil
ocfg = CheckpointConfig(dir=d + "/l4", backend="fti", block_bytes=256,
                        dedicated_thread=False)
ctx5 = CheckpointContext(ocfg)
ctx5.store({"x": x}, id=1, level=4)
x[4000] = -3.0
assert ctx5.store({"x": x}, id=2, level=4, kind=CHK_DIFF).kind == CHK_DIFF
ctx5.shutdown()
shutil.rmtree(d + "/l4/node-local")
for g in glob.glob(d + "/l4/global/ckpt-*"):
    shutil.rmtree(g)
ctx6 = CheckpointContext(ocfg)
assert ctx6.tcl.backend.engine.load_latest()[1]["recovered_via"] == "objstore"
got = ctx6.load({"x": torch.zeros(4096)})
ctx6.shutdown()
assert ctx6.restarted and torch.equal(got["x"], x)

# a reduced training step through the flash path, a store, a restore
import os
os.environ["REPRO_ATTN_IMPL"] = "flash"
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import init_data_state, next_batch
from repro_torch.models.zoo import build_model
from repro_torch.core.protect import flatten_named
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.state import init_train_state, prng_key
from repro_torch.train.step import make_train_step
acfg = get_arch("tinyllama-1.1b").reduced()
model = build_model(acfg)
st = init_train_state(model.init(torch.Generator().manual_seed(0)),
                      prng_key(1), init_data_state(0))
batch, ds = next_batch(st.data_state, acfg, 2, 32)
st, met = make_train_step(model, AdamWConfig())(st, batch)
st = st._replace(data_state=ds)
assert torch.isfinite(met["loss"]) and int(st.step) == 1
# a reduced MoE model: a forward and a donated train step
mcfg = get_arch("granite-moe-3b-a800m").reduced()
mm = build_model(mcfg)
ms = init_train_state(mm.init(torch.Generator().manual_seed(0)),
                      prng_key(1), init_data_state(0))
mb, _ = next_batch(ms.data_state, mcfg, 2, 32)
mlogits, maux = mm.forward(ms.params, mb)
assert float(maux) > 0 and bool(torch.isfinite(mlogits.float()).all())
membed = ms.params["embed"]
ms, mmet = make_train_step(mm, AdamWConfig(), donate=True)(ms, mb)
assert ms.params["embed"] is membed and torch.isfinite(mmet["loss"])
tcfg = CheckpointConfig(dir=d + "/train", backend="fti", objstore=False)
ctx3 = CheckpointContext(tcfg)
ctx3.store(st, id=1, level=1)
ctx3.shutdown()
ctx4 = CheckpointContext(tcfg)
back = ctx4.load(init_train_state(model.init(torch.Generator().manual_seed(9)),
                                  prng_key(0), init_data_state(0)))
ctx4.shutdown()
a, b = flatten_named(st), flatten_named(back)
assert ctx4.restarted and all(torch.equal(a[k], b[k]) for k in a)
# serving: prefill, generate, a store of the ServeState and a restore,
# then a weight swap pulled from the object store by a FleetDeployer
from repro_torch.objstore.client import make_object_store
from repro_torch.serve.deploy import FleetDeployer, Replica
from repro_torch.serve.engine import ServeState, ServingEngine
params = model.init(torch.Generator().manual_seed(3))
eng = ServingEngine(model, params, batch=2, max_len=16)
eng.prefill(torch.randint(0, acfg.vocab_size, (2, 4), dtype=torch.int32))
toks = eng.generate(3)
assert toks.shape == (2, 3) and int(eng.get_state().pos) == 7
scfg = CheckpointConfig(dir=d + "/serve", backend="fti", objstore=False)
ctx7 = CheckpointContext(scfg)
ctx7.store(eng.get_state(), id=7, level=1)
ctx7.shutdown()
ctx8 = CheckpointContext(scfg)
cold = ServeState(model.init_caches(2, 16, device="cpu"),
                  torch.tensor(0, dtype=torch.int32),
                  torch.zeros((2, 1), dtype=torch.int32))
back = ctx8.load(cold)
ctx8.shutdown()
assert ctx8.restarted and int(back.pos) == 7
pub = CheckpointContext(CheckpointConfig(
    dir=d + "/pub", backend="fti", dedicated_thread=False,
    objstore_cdc_min_bytes=1024, objstore_cdc_avg_bytes=4096,
    objstore_cdc_max_bytes=16384))
pub.store({"params": params}, id=1, level=4)
pub.shutdown()
dep = FleetDeployer(make_object_store("file:" + d + "/pub/objstore"),
                    [Replica(name="r0", engine=eng, cache_root=d + "/cache",
                             prefix="params")])
assert dep.run_until_converged()["action"] == "converged"
assert eng.weights.entry_id == 1 and torch.equal(eng.params["embed"],
                                                  params["embed"])
assert eng.generate(2).shape == (2, 2)
# MLA: a reduced minicpm3's absorbed-form decode over its latent cache,
# served and its ServeState stored and restored
ccfg = get_arch("minicpm3-4b").reduced()
cm = build_model(ccfg)
cparams = cm.init(torch.Generator().manual_seed(4))
cc = cm.init_caches(2, 16, device="cpu")
clog, cc2 = cm.decode_step(cparams, torch.ones((2, 1), dtype=torch.int32),
                           cc, 0)
assert cc2 is cc and bool(cc[0].c_kv[:, :, 0].any()) and \
    not bool(cc[0].c_kv[:, :, 1:].any())
assert clog.shape == (2, 1, ccfg.vocab_size)
ceng = ServingEngine(cm, cparams, batch=2, max_len=16)
ceng.prefill(torch.randint(0, ccfg.vocab_size, (2, 4), dtype=torch.int32))
ceng.generate(3)
ctx9 = CheckpointContext(CheckpointConfig(dir=d + "/mla", backend="fti",
                                          objstore=False))
ctx9.store(ceng.get_state(), id=7, level=1)
ctx9.shutdown()
ctx10 = CheckpointContext(CheckpointConfig(dir=d + "/mla", objstore=False))
cback = ctx10.load(ServeState(cm.init_caches(2, 16, device="cpu"),
                              torch.tensor(0, dtype=torch.int32),
                              torch.zeros((2, 1), dtype=torch.int32)))
ctx10.shutdown()
assert ctx10.restarted and torch.equal(cback.caches[0].k_rope,
                                       ceng.state.caches[0].k_rope)
# RWKV6: a reduced rwkv6-3b decodes over its recurrent state (written in
# place), is served, and its ServeState (every block dirty after 4 more
# tokens: the DIFF is promoted to FULL) is stored and restored
rcfg = get_arch("rwkv6-3b").reduced()
rm = build_model(rcfg)
rparams = rm.init(torch.Generator().manual_seed(5))
rc = rm.init_caches(2, 16, device="cpu")
rwkv = rc[0].wkv
rlog, rc2 = rm.decode_step(rparams, torch.ones((2, 1), dtype=torch.int32),
                           rc, 0)
assert rc2 is rc and rc[0].wkv is rwkv and bool(rwkv.any())
assert rlog.shape == (2, 1, rcfg.vocab_size)
reng = ServingEngine(rm, rparams, batch=2, max_len=16)
reng.prefill(torch.randint(0, rcfg.vocab_size, (2, 4), dtype=torch.int32))
rcfg_ck = CheckpointConfig(dir=d + "/rwkv", backend="fti", block_bytes=256,
                           dedicated_thread=False, objstore=False)
ctx11 = CheckpointContext(rcfg_ck)
ctx11.store(reng.get_state(), id=4, level=1)
reng.generate(4)
assert ctx11.store(reng.get_state(), id=8, level=1,
                   kind=CHK_DIFF).promoted_full
ctx11.shutdown()
ctx12 = CheckpointContext(rcfg_ck)
rback = ctx12.load(ServeState(rm.init_caches(2, 16, device="cpu"),
                              torch.tensor(0, dtype=torch.int32),
                              torch.zeros((2, 1), dtype=torch.int32)))
ctx12.shutdown()
assert ctx12.restarted and int(rback.pos) == 8 and torch.equal(
    rback.caches[0].wkv, reng.state.caches[0].wkv)
# the encoder-decoder: a reduced whisper-small's forward (frames and
# tokens) and one decode step, its self-KV row written in place
wcfg = get_arch("whisper-small").reduced()
wm = build_model(wcfg)
wparams = wm.init(torch.Generator().manual_seed(6))
wb, _ = next_batch(init_data_state(0), wcfg, 2, 32)
wlog, waux = wm.forward(wparams, wb)
assert wlog.shape == (2, 32, wcfg.vocab_size) and float(waux) == 0.0
assert bool(torch.isfinite(wlog.float()).all())
wc = wm.init_caches(2, 16, device="cpu", enc_len=32)
wlog1, wc2 = wm.decode_step(wparams, torch.ones((2, 1), dtype=torch.int32),
                            wc, 0)
assert wc2 is wc and wlog1.shape == (2, 1, wcfg.vocab_size)
assert bool(wc.self_kv.k[:, :, 0].any()) and \
    not bool(wc.self_kv.k[:, :, 1:].any())
# chaos: one scenario cell on the CPU, the CLI tools, an elastic restore
import repro_torch.tools.chkls, repro_torch.tools.chktrace
from repro_torch.chaos.scenarios import run_scenario
from repro_torch.core import manifest as mf
from repro_torch.core.resharding import save_sharded
from repro_torch.ft.elastic import rescale_restore
r = run_scenario("node-loss-mid-store", "fti", d + "/chaos", device="cpu")
assert r.ok and r.data_loss_bytes == 0 and r.recovery_path == "partner"
g = torch.arange(40, dtype=torch.float32).reshape(10, 4)
cd = mf.begin(d + "/el", 3)
for k in range(2):
    save_sharded(cd + f"/rank{k}.chk5", {"g": g[5 * k:5 * k + 5]},
                 {"g": 5 * k}, {"g": [10, 4]})
mf.write_manifest(d + "/el", 3, {"kind": "FULL", "level": 4})
mf.commit(d + "/el", 3)
el, cid = rescale_restore([d + "/el"], 3, 1)
assert cid == 3 and el["g"].tobytes() == g[4:7].numpy().tobytes()
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print("isolated-ok")
"""


def test_main_path_runs_without_jax_or_the_reference_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated-ok" in out.stdout


#: a worker of ``repro_torch.launch.meshckpt`` with jax and the reference
#: package made unimportable first
_NO_JAX_WORKER = ("import runpy, sys; sys.modules['jax'] = None; "
                  "sys.modules['repro'] = None; "
                  "runpy.run_module('repro_torch.launch.meshckpt', "
                  "run_name='__main__', alter_sys=True)")


def test_mesh_store_and_restore_run_without_jax_in_every_worker(tmp_path):
    """Two gloo processes store reduced tinyllama from a (1, 2) mesh
    (shard-local, FULL + DIFF), two new ones restore it onto (2, 1): every
    worker runs with ``sys.modules["jax"] = None``, and every box equals
    the source's."""
    from repro_torch.launch.meshckpt import compare
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    common = ["--reduced", "--device", "cpu", "--block-bytes", "256",
              "--dir", str(tmp_path / "ck"), "--out", str(tmp_path / "out")]
    for argv in (["store", "--mesh", "1,2", "--targets", "2,1"],
                 ["restore", "--mesh", "2,1", "--source-mesh", "1,2"]):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "--no-python", sys.executable, "-c",
             _NO_JAX_WORKER, *argv, *common],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    import json
    load = [[json.loads((tmp_path / "out" / f"{n}-rank{r}.json").read_text())
             for r in range(2)] for n in ("store", "restore-2x1")]
    assert all(s["dirty_blocks"] == s["expected_dirty"] for s in load[0])
    assert all(r["restarted"] and r["placements_kept"] for r in load[1])
    assert compare(*load) > 0


#: every module this slice added, imported with jax and the reference
#: package unimportable; then the calibration count and a sharded
#: forward on a one-process mesh
_NEW_MODULES = r"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
for name in ("repro_torch.roofline", "repro_torch.roofline.hw",
             "repro_torch.roofline.analytic", "repro_torch.roofline.analyze",
             "repro_torch.roofline.calibrate",
             "repro_torch.roofline.perf_loop", "repro_torch.roofline.report",
             "repro_torch.launch.dryrun"):
    importlib.import_module(name)
import torch
from repro_torch.roofline.calibrate import compiled_flops
assert compiled_flops(False) > 0
from repro_torch.configs import get_arch
from repro_torch.core.resharding import reshard_tree
from repro_torch.dist.context import use_mesh
from repro_torch.dist.sharding import batch_sharding, param_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.zoo import build_model
m = build_model(get_arch("tinyllama-1.1b").reduced())
p = m.init(torch.Generator().manual_seed(0))
t = torch.zeros((2, 16), dtype=torch.int32)
mesh = make_host_mesh()
dp = reshard_tree(p, param_shardings(mesh, m.param_struct()))
dt = reshard_tree({"tokens": t}, {"tokens": batch_sharding(mesh, 2)})
with use_mesh(mesh):
    got, _ = m.forward(dp, dt)
assert torch.equal(got.full_tensor(), m.forward(p, {"tokens": t})[0])
print("new-modules-ok")
"""


def test_new_modules_import_and_run_without_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "new-modules-ok" in out.stdout


def test_no_module_of_the_port_imports_jax_or_repro():
    """Every import statement in src/repro_torch, lazy ones included."""
    bad = []
    paths = sorted((SRC / "repro_torch").rglob("*.py"))
    scanned = {str(p.relative_to(SRC / "repro_torch")) for p in paths}
    assert {"models/attention.py", "models/transformer.py", "models/moe.py",
            "models/ssm.py", "models/encdec.py", "dist/compression.py",
            "kernels/flashattn.py", "train/step.py", "train/loop.py",
            "launch/train.py", "data/synthetic.py", "configs/base.py",
            "core/incremental.py", "backends/scr.py", "objstore/tier.py",
            "objstore/cdc.py", "objstore/chunks.py", "objstore/subscriber.py",
            "serve/engine.py", "serve/deploy.py", "launch/serve.py",
            "core/resharding.py", "chaos/scenarios.py", "chaos/runner.py",
            "ft/elastic.py", "ft/straggler.py", "tools/chkls.py",
            "tools/chktrace.py", "dist/context.py", "dist/sharding.py",
            "dist/comm.py", "launch/mesh.py", "launch/meshckpt.py",
            "launch/dryrun.py", "roofline/hw.py", "roofline/analytic.py",
            "roofline/analyze.py", "roofline/calibrate.py",
            "roofline/perf_loop.py", "roofline/report.py"} <= scanned
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(SRC)}: {n}")
    assert not bad, bad


#: the CPU rehearsal's cases: phases, the child's time limit in seconds,
#: and the lines it must print.  Each limit is 4x or more what the case
#: took beside the multi-process tests on six pytest workers on eight
#: cores (33, 11, 40, 14 and 14 s).
REHEARSALS = {
    # the directive path (FULL, in-place update before the async tail,
    # DIFF with the exact dirty count, promoted FULL, DIFF, restart), the
    # checkpointed training (run A vs store, fault, restore, resume) on a
    # reduced config, and phase 6 (object store, incremental, SCR)
    "directive-training-objstore": ("3,5,6", 150, [
        "dirty blocks: store 2",
        "resumed TrainState equals run A's bit for bit",
        "restore from the object store alone: 13 leaves bit-exact on cpu",
        "SCR FULL store"]),
    # serving and deploy, phase 10: MLA served and resumed, phase 11:
    # RWKV6 served and resumed, every cadence store promoted to FULL
    "serve-deploy-mla-ssm": ("7,10,11", 120, [
        "generates the 4 tokens of an engine built on",
        "[mla] restore:",
        "[ssm] every cadence store promoted to FULL (3)"]),
    # phase 8: the chaos matrix, the elastic rescale, the sharded
    # directive restore with its fall back, and the supervised kill
    "chaos-elastic-supervised": ("8", 180, [
        "[chaos] matrix on cpu: 24/24 passed, data loss 0 B",
        "new world 3: every rank's rows on cpu equal",
        "restores it into zeros on cpu bit-exact",
        "the walk fell back to id 1",
        "resumed from step 6, one restart",
        "the restarted worker's launches"]),
    # phase 9: MoE trained, faulted and resumed; phase 12: the
    # encoder-decoder (whisper-small) trained, faulted and resumed
    "moe-encdec": ("9,12", 120, [
        "[moe] resumed TrainState equals run A's bit for bit",
        "[encdec] resumed TrainState equals run A's bit for bit"]),
    # phase 14: the seven examples in one process, each one's result held
    "examples": ("14", 120, [
        "torch_quickstart.py: done at step 50; the rerun resumed",
        "torch_differential_demo.py: a DIFF, a promoted FULL",
        "torch_serve_resilient.py: resumed at pos 22",
        "torch_clause_protection.py: params within",
        "torch_multibackend_portability.py: x0=20 and the restart",
        "torch_telemetry_trace.py: span",
        "torch_train_checkpointed.py: faulted at step 18, finished at 20"]),
}


@pytest.mark.parametrize("case", list(REHEARSALS))
def test_chip_smoke_main_path_rehearses_on_cpu(case, tmp_path):
    """chip_smoke.py's main paths at a tiny width with the plain versions,
    by groups of phases (``--phases``), each in its own ``--workdir``."""
    phases, limit, wanted = REHEARSALS[case]
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--device", "cpu", "--layers", "1",
         "--width-div", "16", "--block-bytes", "256", "--phases", phases,
         "--workdir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=limit)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    for line in wanted:
        assert line in out.stdout, line
    if case == "serve-deploy-mla-ssm":
        # phase 7 (tinyllama), phase 10 (MLA: minicpm3's latent cache) and
        # phase 11 (RWKV6: rwkv6-3b's recurrent state)
        assert out.stdout.count(
            "final ServeState equal run A's bit for bit") == 3
    assert f"CPU rehearsal of phases {phases.replace(',', ', ')} passed" \
        in out.stdout
    assert '"ok"' not in out.stdout            # a CPU run prints no result


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would really run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "is_available() is false" in out.stderr


def test_chip_smoke_alone_outside_a_checkout_fails(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "src/repro_torch not found" in out.stderr
