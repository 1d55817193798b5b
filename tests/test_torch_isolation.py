"""The port stands alone: ``repro_torch`` imports neither jax nor any module
of the JAX package ``repro``, and its main path runs with jax absent — as
``chip_smoke.py`` drives it, which also refuses to run without a card."""
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


def test_no_module_of_the_port_imports_jax_or_repro():
    """Every import statement in src/repro_torch, lazy ones included."""
    bad = []
    paths = sorted((SRC / "repro_torch").rglob("*.py"))
    scanned = {str(p.relative_to(SRC / "repro_torch")) for p in paths}
    assert {"models/attention.py", "models/transformer.py",
            "kernels/flashattn.py", "train/step.py", "train/loop.py",
            "launch/train.py", "data/synthetic.py",
            "configs/base.py"} <= scanned
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


def test_chip_smoke_main_path_rehearses_on_cpu():
    """chip_smoke.py's main paths at a tiny width with the plain versions:
    the directive path (FULL, in-place update before the async tail, DIFF
    with the exact dirty count, promoted FULL, DIFF, restart) and the
    checkpointed training (run A vs store, fault, restore, resume) on a
    reduced config."""
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", "--device", "cpu", "--layers", "1",
         "--width-div", "16", "--block-bytes", "256"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dirty blocks: store 2" in out.stdout
    assert "resumed TrainState equals run A's bit for bit" in out.stdout
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
