"""The port's roofline modules against the JAX package's.

- Mirrors of the 10 tests of ``tests/test_roofline.py`` on
  ``repro_torch.roofline``: the HLO collective parser (copied, so the
  same text gives the same counts and wire bytes), the analytic model's
  invariants, and, in place of XLA's scan body counted once, the port's
  counter: ``FlopCounterMode`` counts every pass of an unrolled loop.
- Each copied module equals the reference's after the import-prefix swap.
- ``analytic_report`` equals the reference's on every architecture and
  shape when both read the reference's TPU v5e constants.
- The H100 table holds the datasheet's values.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPE_BY_NAME, get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.roofline import hw
from repro_torch.roofline.analytic import analytic_report
from repro_torch.roofline.analyze import parse_collectives

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HLO_SAMPLE = """
HloModule test
ENTRY main {
  %p = f32[256,1024]{1,0} parameter(0)
  %ar = f32[256,1024]{1,0} all-reduce(f32[256,1024]{1,0} %p), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[1024,4096]{1,0} all-gather(bf16[1024,1024]{1,0} %x), replica_groups={{0,1,2,3}}, dimensions={1}
  %rs = f32[64,1024]{1,0} reduce-scatter(f32[256,1024]{1,0} %p), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = f32[8]{0} collective-permute(f32[8]{0} %y), source_target_pairs={{0,1}}
  %aa = f32[16,16]{1,0} all-to-all(f32[16,16]{1,0} %z), replica_groups={{0,1}}
}
"""


def test_parse_collectives_counts_and_wire():
    stats = parse_collectives(HLO_SAMPLE)
    assert stats.counts == {"all-reduce": 1, "all-gather": 1,
                            "reduce-scatter": 1, "collective-permute": 1,
                            "all-to-all": 1}
    ar = 2 * (256 * 1024 * 4) * 3 / 4
    ag = (1024 * 4096 * 2) * 3 / 4
    rs = (64 * 1024 * 4) * 3
    cp = 8 * 4
    aa = 16 * 16 * 4 * 1 / 2
    assert stats.wire_bytes == pytest.approx(ar + ag + rs + cp + aa)


def test_parse_ignores_done_ops_and_single_groups():
    txt = """
  %a = f32[8]{0} all-reduce-start(f32[8]{0} %p), replica_groups={{0,1}}
  %b = f32[8]{0} all-reduce-done(f32[8]{0} %a)
  %c = f32[8]{0} all-reduce(f32[8]{0} %p), replica_groups={{0}}
"""
    stats = parse_collectives(txt)
    assert stats.counts.get("all-reduce", 0) == 1   # -start only, group>1


def test_loop_counted_every_pass():
    """The reference's motivating XLA behavior is that cost_analysis sees
    a scan body once; the port counts eagerly, so five passes of a loop
    count five times one pass (the dry-run needs no analytic fix-up for
    its loops, and ``calibrate`` counts the layer loop as it runs)."""
    from torch.utils.flop_counter import FlopCounterMode
    w = torch.ones((64, 64), device="meta")
    h = torch.ones((64, 64), device="meta")

    def count(n):
        c = FlopCounterMode(display=False)
        x = h
        with c:
            for _ in range(n):
                x = x @ w
        return c.get_total_flops()

    assert count(5) == pytest.approx(5 * count(1), rel=0.01)
    assert count(1) == 2 * 64 ** 3


# --------------------------- analytic invariants --------------------------- #

ARCHS = ["tinyllama-1.1b", "mixtral-8x7b", "rwkv6-3b", "whisper-small",
         "jamba-1.5-large-398b", "minicpm3-4b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_terms_positive_and_finite(arch):
    cfg = get_arch(arch)
    for shape in cfg.shapes():
        r = analytic_report(cfg, shape, dp=16, tp=16)
        for k in ("t_compute", "t_memory", "t_collective"):
            assert np.isfinite(r[k]) and r[k] >= 0, (arch, shape.name, k)
        assert r["flops_per_device"] > 0
        assert 0 < r["useful_flops_ratio"] < 3, (arch, shape.name,
                                                 r["useful_flops_ratio"])


def test_flops_scale_with_batch():
    cfg = get_arch("tinyllama-1.1b")
    s1 = ShapeSpec("t", "train", 4096, 256)
    s2 = ShapeSpec("t", "train", 4096, 512)
    r1 = analytic_report(cfg, s1, dp=16, tp=16)
    r2 = analytic_report(cfg, s2, dp=16, tp=16)
    assert r2["flops_per_device"] == pytest.approx(
        2 * r1["flops_per_device"], rel=0.01)


def test_no_collectives_on_single_device():
    cfg = get_arch("tinyllama-1.1b")
    r = analytic_report(cfg, SHAPE_BY_NAME["train_4k"], dp=1, tp=1)
    assert r["wire_bytes_per_device"] == 0.0


def test_zero1_wire_equal_fp32_smaller_bf16():
    """ZeRO-1 = RS(grad fp32) + AG(params): equals all-reduce wire at fp32
    params (4+4 vs 2·4 bytes/param); beats it with bf16 params (4+2 < 8)."""
    cfg = get_arch("tinyllama-1.1b")
    sh = SHAPE_BY_NAME["train_4k"]
    base = analytic_report(cfg, sh, dp=16, tp=16)
    z1 = analytic_report(cfg, sh, dp=16, tp=16, zero1=True)
    assert z1["wire_bytes_per_device"] == pytest.approx(
        base["wire_bytes_per_device"])
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    z1b = analytic_report(bf, sh, dp=16, tp=16, zero1=True)
    assert z1b["wire_bytes_per_device"] < base["wire_bytes_per_device"]


def test_swa_cheaper_than_full_attention_at_32k():
    """Mixtral's sliding window must cut prefill attention flops."""
    cfg = get_arch("mixtral-8x7b")
    full = dataclasses.replace(cfg, sliding_window=None)
    sh = SHAPE_BY_NAME["prefill_32k"]
    r_swa = analytic_report(cfg, sh, dp=16, tp=16)
    r_full = analytic_report(full, sh, dp=16, tp=16)
    assert r_swa["flops_per_device"] < 0.75 * r_full["flops_per_device"]


def test_remat_adds_compute_removes_nothing_else():
    cfg = get_arch("llama3.2-3b")
    sh = SHAPE_BY_NAME["train_4k"]
    r_on = analytic_report(cfg, sh, dp=16, tp=16, remat=True)
    r_off = analytic_report(cfg, sh, dp=16, tp=16, remat=False)
    assert r_on["flops_per_device"] == pytest.approx(
        4 / 3 * r_off["flops_per_device"], rel=0.05)


def test_model_flops_moe_counts_active_only():
    cfg = get_arch("mixtral-8x7b")
    n_active = cfg.flops_param_count()
    # mixtral: ~13B active of ~47B total
    total = cfg.param_count(active_only=False)
    assert n_active < 0.35 * total


# --------------------------- against the reference ------------------------- #

COPIES = ["__init__", "analytic", "analyze", "perf_loop", "report"]


@pytest.mark.parametrize("name", COPIES)
def test_copied_module_equals_reference_after_prefix_swap(name):
    port = open(os.path.join(ROOT, "src", "repro_torch", "roofline",
                             f"{name}.py")).read()
    ref = open(os.path.join(ROOT, "src", "repro", "roofline",
                            f"{name}.py")).read()
    assert re.sub(r"\brepro_torch\b", "repro", port) == ref


@pytest.mark.parametrize("arch", sorted(
    ["tinyllama-1.1b", "mixtral-8x7b", "rwkv6-3b", "whisper-small",
     "jamba-1.5-large-398b", "minicpm3-4b", "granite-moe-3b-a800m",
     "llama3.2-3b", "codeqwen1.5-7b", "internvl2-1b"]))
def test_analytic_report_equals_reference_on_tpu_constants(monkeypatch,
                                                           arch):
    """With the port's hardware table set to the reference's TPU v5e
    values, every term of every shape and knob equals the reference's."""
    from repro.configs import get_arch as jget_arch
    from repro.roofline import hw as jhw
    from repro.roofline.analytic import analytic_report as janalytic

    for k in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_LINK_BW", "HBM_BYTES",
              "CHIPS_PER_POD"):
        monkeypatch.setattr(hw, k, getattr(jhw, k))
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for shape in cfg.shapes():
        for knobs in ({}, {"zero1": True}, {"fsdp": True},
                      {"remat": False}):
            for dp, tp in ((16, 16), (32, 16), (1, 1)):
                got = analytic_report(cfg, shape, dp=dp, tp=tp, **knobs)
                want = janalytic(jcfg, shape, dp=dp, tp=tp, **knobs)
                assert got == want, (arch, shape.name, knobs, dp, tp)


def test_h100_table():
    """NVIDIA H100 SXM datasheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
    80 GB; NVLink 4 at 900 GB/s over 18 links is 25 GB/s per link and
    direction; 8 GPUs share one NVLink domain."""
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80e9
    assert hw.ICI_LINK_BW == 900e9 / 18 / 2
    assert hw.CHIPS_PER_POD == 8


def test_calibration_inside_its_band():
    """``calibrate``'s counted FLOPs (forward and gradient on ``meta``
    tensors) against the analytic model: inside 0.8–1.25, as the
    reference's compiled count must be."""
    from repro_torch.roofline import calibrate
    for train in (False, True):
        shape = ShapeSpec("cal", "train" if train else "prefill",
                          calibrate.SEQ, calibrate.BATCH)
        ana = analytic_report(calibrate.CAL_CFG, shape, dp=1, tp=1,
                              remat=False)["flops_per_device"]
        if train:
            ana -= 12.0 * calibrate.CAL_CFG.param_count()
        ratio = ana / calibrate.compiled_flops(train)
        assert 0.8 < ratio < 1.25, (train, ratio)
