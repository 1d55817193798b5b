"""Calibrate the analytic cost model against counted FLOPs.

A mid-size llama-family config (the reference's) runs its forward — and,
for training, its gradient — on ``meta`` tensors under
``torch.utils.flop_counter.FlopCounterMode``: no memory, no device, every
matrix product of the (unrolled) layer loop counted.  The analytic model
is evaluated at dp = tp = 1; agreement of the FLOP counts (the
reference's 0.8–1.25 band) validates the model the roofline tables are
built from.  The reference counts XLA's ``cost_analysis`` of a compiled,
unrolled module instead.

Run:  PYTHONPATH=src python -m repro_torch.roofline.calibrate
"""
from __future__ import annotations

import json
import os

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer as lm
from repro_torch.roofline.analytic import analytic_report

CAL_CFG = ArchConfig(
    name="cal-llama",
    family="dense",
    n_layers=4,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=1536,
    vocab_size=8192,
)

BATCH, SEQ = 4, 512


def compiled_flops(train: bool) -> float:
    """FLOPs of the calibration model's bf16 forward (and, with
    ``train``, of the gradient of its mean cross-entropy), counted on
    ``meta`` tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.protect import flatten_named
    from repro_torch.models.layers import softmax_cross_entropy

    params = lm.lm_param_struct(CAL_CFG)
    tokens = torch.zeros((BATCH, SEQ), dtype=torch.int64, device="meta")

    def fwd(params):
        h = torch.nn.functional.embedding(tokens, params["embed"]).to(
            torch.bfloat16)
        h, _ = lm.lm_backbone(params, h, CAL_CFG, remat=False)
        return lm.lm_logits(params, h, CAL_CFG)

    counter = FlopCounterMode(display=False)
    if train:
        leaves = list(flatten_named(params).values())
        for x in leaves:
            x.requires_grad_(True)
        with counter:
            loss = torch.mean(softmax_cross_entropy(fwd(params), tokens))
            torch.autograd.grad(loss, leaves)
    else:
        with counter, torch.no_grad():
            fwd(params)
    return float(counter.get_total_flops())


def main(out_path: str = "reports/calibration.json") -> int:
    out = {}
    for train in (False, True):
        shape = ShapeSpec("cal", "train" if train else "prefill", SEQ, BATCH)
        ana = analytic_report(CAL_CFG, shape, dp=1, tp=1, remat=False)
        hlo = compiled_flops(train)
        # analytic counts the optimizer+grad-clip update (~12 flops/param);
        # the calibration graph is grad-only, so compare backbone flops
        ana_f = ana["flops_per_device"]
        if train:
            ana_f -= 12.0 * CAL_CFG.param_count()
        ratio = ana_f / hlo
        out["train" if train else "forward"] = {
            "analytic_flops": ana_f, "hlo_flops": hlo, "ratio": ratio}
        print(f"{'train' if train else 'fwd '}: analytic {ana_f:.3e} vs "
              f"counted {hlo:.3e} → ratio {ratio:.3f}")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    ok = all(0.8 < v["ratio"] < 1.25 for v in out.values())
    print("calibration", "OK" if ok else "OUT OF BAND")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
