"""End-to-end restart semantics of the port (the single-device parts of
tests/test_restart.py, mirrored: the resume and cursor cases are in
tests/test_torch_train.py), and the training launcher's level cycle, which
now reaches level 4 with the object-store rung the JAX launcher writes.
"""
import inspect
import os
import sys

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.context import (
    CHK_DIFF,
    CheckpointConfig,
    CheckpointContext,
    Protect,
)
from repro_torch.data.synthetic import init_data_state
from repro_torch.ft.failures import FaultInjector, SimulatedFault
from repro_torch.models.zoo import build_model
from repro_torch.objstore.catalog import Catalog
from repro_torch.objstore.client import make_object_store
from repro_torch.train.loop import LevelSchedule, LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.state import init_train_state, prng_key
from repro_torch.train.step import make_train_step


def _ctx(d):
    return CheckpointContext(CheckpointConfig(dir=str(d), backend="fti",
                                              dedicated_thread=False))


def test_if_clause_switches_off(tmp_path):
    state = {"x": torch.ones(4)}
    ctx = _ctx(tmp_path / "i")
    assert ctx.store(state, id=1, level=1, if_=False) is None
    assert ctx.stats["stores"] == 0
    assert ctx.load(state, if_=False) is state
    ctx.shutdown()


def test_id_level_mandatory():
    sig = inspect.signature(CheckpointContext.store)
    assert sig.parameters["id"].default is inspect.Parameter.empty
    assert sig.parameters["level"].default is inspect.Parameter.empty


def test_selectors_protect_subtree(tmp_path):
    state = {"params": {"w": torch.arange(4.0)}, "opt": {"m": torch.zeros(4)},
             "step": torch.tensor(3, dtype=torch.int32)}
    ctx = _ctx(tmp_path / "s")
    ctx.protect(Protect("params/**"), Protect("step"))
    ctx.store(state, id=1, level=1)
    ctx.shutdown()
    ctx2 = _ctx(tmp_path / "s")
    ctx2.protect(Protect("params/**"), Protect("step"))
    got = ctx2.load({"params": {"w": torch.zeros(4)},
                     "opt": {"m": torch.ones(4) * 9},
                     "step": torch.tensor(0, dtype=torch.int32)})
    assert torch.equal(got["params"]["w"], torch.arange(4.0))
    assert int(got["step"]) == 3
    assert torch.equal(got["opt"]["m"], torch.ones(4) * 9)   # unprotected
    ctx2.shutdown()


def test_store_after_shutdown_raises(tmp_path):
    ctx = _ctx(tmp_path / "z")
    ctx.shutdown()
    with pytest.raises(RuntimeError):
        ctx.store({"x": torch.ones(2)}, id=1, level=1)


def test_diff_then_restart_loop(tmp_path):
    """Differential checkpoints through the training loop + restart: the
    restore replays the DIFF chain onto the template's leaves."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    m = build_model(cfg)
    state = init_train_state(m.init(torch.Generator().manual_seed(0)),
                             prng_key(1), init_data_state(0))
    step = make_train_step(m, AdamWConfig(total_steps=20, warmup_steps=2),
                           remat=False)
    loop = LoopConfig(total_steps=6, ckpt_every=2, kind=CHK_DIFF,
                      levels=LevelSchedule(l2_every=0, l3_every=0,
                                           l4_every=0))
    ctx = _ctx(tmp_path / "d")
    with pytest.raises(SimulatedFault):
        run_training(m, step, state, ctx, loop, 2, 32,
                     injector=FaultInjector(total_steps=6, at_progress=0.9),
                     log=lambda *_: None)
    ctx.shutdown()
    ctx2 = _ctx(tmp_path / "d")
    out = run_training(m, step, state, ctx2, loop, 2, 32, log=lambda *_: None)
    assert out["restarted"] and out["final_step"] == 6
    ctx2.shutdown()


def test_launcher_level_cycle_reaches_l4_and_publishes_to_the_catalog(
        tmp_path, monkeypatch, capsys):
    """With the default config (``objstore=True``, as in the JAX launcher)
    the eighth checkpoint of the FTI level cycle is a level-4 store: it
    lands in the global directory and in the object store's catalog."""
    from repro_torch.launch import train as launch
    d = tmp_path / "run"
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--steps", "8", "--ckpt-every", "1",
        "--batch", "1", "--seq", "16", "--ckpt-dir", str(d),
        "--no-dedicated-thread"])
    assert launch.main() == 0
    out = capsys.readouterr().out
    assert "'restarted': False" in out
    cat = Catalog(make_object_store("file:" + os.path.join(d, "objstore")))
    assert cat.ids() == [8]
    entry = cat.entry(8)
    assert entry["manifest"]["level"] == 4
    assert "rank0.chk5" in entry["files"]
    assert os.path.isdir(os.path.join(d, "global", "ckpt-8"))


@pytest.mark.parametrize("layers", [None, 1])
def test_launcher_layers_cuts_the_depth_and_keeps_the_widths(
        tmp_path, monkeypatch, capsys, layers):
    """``--layers N`` trains the config at N layers with its widths (the
    cut phase 8's supervised kill workers take on the card); without it,
    every layer of the config."""
    from repro_torch.launch import train as launch
    d = tmp_path / "run"
    argv = ["train", "--device", "cpu", "--steps", "1", "--ckpt-every", "1",
            "--batch", "1", "--seq", "16", "--ckpt-dir", str(d),
            "--no-dedicated-thread"]
    if layers is not None:
        argv += ["--layers", str(layers)]
    monkeypatch.setattr(sys, "argv", argv)
    assert launch.main() == 0
    assert "'final_step': 1" in capsys.readouterr().out
    cfg = get_arch("tinyllama-1.1b").reduced()
    want = cfg.n_layers if layers is None else layers
    ctx = _ctx(d)
    got = ctx.load({"params": {"groups": [{"attn": {"wq": torch.zeros(
        want, cfg.d_model, cfg.n_heads * cfg.head_dim)}}]}})
    assert ctx.restarted
    assert got["params"]["groups"][0]["attn"]["wq"].shape[0] == want
    ctx.shutdown()
