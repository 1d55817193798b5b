"""The port's examples and its serving launcher, run as a user runs them,
with ``--device cpu`` in a subprocess (their default device is ``cuda``)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def run(args, cwd=ROOT, timeout=240):
    out = subprocess.run([sys.executable] + args, cwd=cwd, env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr


def test_quickstart_runs_and_restarts(tmp_path):
    args = [str(ROOT / "examples" / "torch_quickstart.py"), "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "qs")]
    rc, out, err = run(args)
    assert rc == 0, err[-3000:]
    assert "done at step 50, w[0]=5.00 on cpu" in out
    assert "transparent restart" not in out
    rc, out, err = run(args)
    assert rc == 0, err[-3000:]
    assert "transparent restart: resuming from step 50" in out


def test_differential_demo_ships_a_delta_and_promotes(tmp_path):
    rc, out, err = run([str(ROOT / "examples" / "torch_differential_demo.py"),
                        "--device", "cpu", "--ckpt-dir", str(tmp_path / "dd")])
    assert rc == 0, err[-3000:]
    assert "id=2 DIFF" in out and "promoted=True" in out
    assert "replayed restore exact on cpu" in out


def test_serve_resilient_resumes_without_prefill(tmp_path):
    rc, out, err = run([str(ROOT / "examples" / "torch_serve_resilient.py"),
                        "--device", "cpu", "--ckpt-dir", str(tmp_path / "sr")])
    assert rc == 0, err[-3000:]
    assert "server 2 resumed at pos 22" in out
    assert "resumed continuation matches uninterrupted generation" in out


def test_serve_launcher_kill_and_resume(tmp_path):
    """``python -m repro_torch.launch.serve --device cpu``: a run killed
    after 12 tokens (its last store at 8), then a rerun that resumes at
    the stored position without prefill and finishes."""
    base = ["-m", "repro_torch.launch.serve", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "sv"), "--gen", "20"]
    rc, out, err = run(base + ["--kill-after", "12"])
    assert rc == 39, err[-3000:]
    assert "simulated failure after 12 tokens" in out
    rc, out, err = run(base)
    assert rc == 0, err[-3000:]
    assert "resumed at pos 24" in out and "generated 12 tokens/req" in out


def test_serve_launcher_follows_the_catalog(tmp_path):
    """``--follow-catalog``: a FULL params tree published at L4 into an
    object store is pulled and swapped into the serving engine between
    batches."""
    from repro_torch.configs import get_arch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.models.zoo import build_model
    model = build_model(get_arch("tinyllama-1.1b").reduced())
    ctx = CheckpointContext(CheckpointConfig(
        dir=str(tmp_path / "pub"), backend="fti", dedicated_thread=False,
        objstore_cdc_min_bytes=1024, objstore_cdc_avg_bytes=4096,
        objstore_cdc_max_bytes=16384))
    ctx.store({"params": model.init(torch.Generator().manual_seed(5))},
              id=1, level=4)
    ctx.shutdown()
    rc, out, err = run(["-m", "repro_torch.launch.serve", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path / "sv"), "--gen", "4",
                        "--follow-catalog",
                        "file:" + str(tmp_path / "pub" / "objstore")])
    assert rc == 0, err[-3000:]
    assert "deploying catalog entry 1" in out
    assert "weights swapped: epoch 0 -> 1 (catalog entry 1)" in out


def test_serve_launcher_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would really serve")
    rc, _out, err = run(["-m", "repro_torch.launch.serve",
                         "--ckpt-dir", str(tmp_path / "sv")])
    assert rc != 0 and "pass --device cpu" in err
