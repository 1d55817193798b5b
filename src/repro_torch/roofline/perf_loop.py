"""§Perf hillclimb: hypothesis → change → measure → validate, per cell.

Three cells (selection rule from the deliverable):
  A. granite-moe-3b-a800m × train_4k — WORST roofline fraction (0.013);
  B. tinyllama-1.1b × train_4k — most COLLECTIVE-bound (t_coll/t_next max);
  C. jamba-1.5-large-398b × train_4k — most representative of the paper's
     technique (largest checkpoint state: 398B params ⇒ CR cost dominates
     operational behavior; also collective-bound and over HBM at baseline).

Each iteration is a knob set over the analytic cost model (the same model
the dry-run embeds); structural knobs (dp_only / fsdp / zero1 / bf16) are
additionally *compile-verified* on the production mesh via launch/dryrun.
Run:  PYTHONPATH=src python -m repro_torch.roofline.perf_loop [--verify-compiles]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List

from repro_torch.configs import SHAPE_BY_NAME, get_arch
from repro_torch.roofline.analytic import analytic_report


def _run(arch: str, shape: str, dp=16, tp=16, param_dtype=None,
         moe_dispatch=None, **knobs) -> Dict[str, Any]:
    cfg = get_arch(arch)
    if param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    if moe_dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    return analytic_report(cfg, SHAPE_BY_NAME[shape], dp=dp, tp=tp, **knobs)


CELLS: Dict[str, Dict[str, Any]] = {
    "A:granite-moe-3b-a800m/train_4k": {
        "arch": "granite-moe-3b-a800m",
        "shape": "train_4k",
        "why": "worst baseline roofline fraction",
        "iterations": [
            {
                "name": "A1-flash-attention",
                "hypothesis": (
                    "memory term (8.41s) is dominated by attention score "
                    "HBM traffic: 24 heads % 16 ≠ 0 ⇒ heads unshardable on "
                    "the model axis, so every device carries full-head "
                    "score tensors — b16·h24·4096²·4B·2(rw)·4(remat) ≈ "
                    "20.6 TB/dev of the 6.9 TB total is impossible, but "
                    "score+kv streaming is the top byte site; fusing "
                    "attention (Pallas flash kernel, kernels/flashattn.py) "
                    "eliminates the score round-trip entirely"),
                "knobs": {"attn_impl": "flash"},
            },
            {
                "name": "A2-scatter-dispatch",
                "hypothesis": (
                    "fine-grained MoE (E=40, top-8, d_ff=512) pays "
                    "one-hot dispatch einsum flops ≈ group·topk·cf·d per "
                    "token ≈ 33% of expert flops; sort-based scatter "
                    "dispatch moves this to bytes"),
                "knobs": {"attn_impl": "flash", "moe_dispatch": "scatter"},
            },
            {
                "name": "A3-zero1-bf16-int8",
                "hypothesis": (
                    "with memory fixed, the collective term (grad sync "
                    "fp32 over dp=16) is next; bf16 params + ZeRO-1 + int8 "
                    "compressed gradients cut grad wire 8/3 ≈ 2.7×"),
                "knobs": {"attn_impl": "flash", "moe_dispatch": "scatter",
                          "param_dtype": "bfloat16", "zero1": True,
                          "grad_compress": "int8"},
            },
            {
                "name": "A4-overlap-gradsync",
                "hypothesis": (
                    "remaining grad wire can hide under backward compute "
                    "(bucketed async all-reduce); exposed collective time "
                    "→ max(0, t_grad − t_compute)"),
                "knobs": {"attn_impl": "flash", "moe_dispatch": "scatter",
                          "param_dtype": "bfloat16", "zero1": True,
                          "grad_compress": "int8", "overlap_gradsync": True},
            },
            {
                "name": "A5-dp-only",
                "hypothesis": (
                    "still collective-bound: TP psums on d=1536 "
                    "activations — same disease as cell B. 3.3B params at "
                    "bf16 = 6.6GB replicate fine; fold the model axis "
                    "into data (dp=256, tp=1): psums vanish, grad sync "
                    "int8+ZeRO over 256 is cheap"),
                "knobs": {"dp": 256, "tp": 1, "attn_impl": "flash",
                          "moe_dispatch": "scatter",
                          "param_dtype": "bfloat16", "zero1": True,
                          "grad_compress": "int8", "overlap_gradsync": True},
                "verify_compile": ["--dp-only", "--zero1",
                                   "--param-dtype", "bfloat16",
                                   "--moe-dispatch", "scatter"],
            },
        ],
    },
    "B:tinyllama-1.1b/train_4k": {
        "arch": "tinyllama-1.1b",
        "shape": "train_4k",
        "why": "most collective-bound cell (t_coll 1.8× next term)",
        "iterations": [
            {
                "name": "B1-dp-only",
                "hypothesis": (
                    "TP=16 Megatron psums on a 1.1B/d=2048 model cost "
                    "~132 psums × 268MB ≈ 66GB wire (1.35s) while the MXU "
                    "work per device is tiny; using the model axis as "
                    "extra data parallelism (dp=256, params replicated) "
                    "removes ALL TP psums for a grad all-reduce of "
                    "2·4.4GB·255/256 ≈ 8.8GB (0.18s) — 7.7× less wire"),
                "knobs": {"dp": 256, "tp": 1},
                "verify_compile": ["--dp-only"],
            },
            {
                "name": "B2-zero1-bf16",
                "hypothesis": (
                    "grad sync now dominates the collective term; bf16 "
                    "params with ZeRO-1 (RS fp32 grads + AG bf16 params) "
                    "cut wire to 6/8 and shard optimizer traffic 256-way"),
                "knobs": {"dp": 256, "tp": 1, "zero1": True,
                          "param_dtype": "bfloat16"},
                "verify_compile": ["--dp-only", "--zero1",
                                   "--param-dtype", "bfloat16"],
            },
            {
                "name": "B3-int8-grads",
                "hypothesis": (
                    "int8 block-quantized gradients with error feedback "
                    "(dist/compression.py) cut the RS payload 4× more: "
                    "wire → P·(1+2)·frac"),
                "knobs": {"dp": 256, "tp": 1, "zero1": True,
                          "param_dtype": "bfloat16", "grad_compress": "int8"},
            },
            {
                "name": "B4-flash-attention",
                "hypothesis": (
                    "collective fixed ⇒ memory-bound on score traffic; "
                    "fused flash attention removes it"),
                "knobs": {"dp": 256, "tp": 1, "zero1": True,
                          "param_dtype": "bfloat16", "grad_compress": "int8",
                          "attn_impl": "flash"},
            },
            {
                "name": "B5-overlap-gradsync",
                "hypothesis": "hide the remaining grad wire under backward",
                "knobs": {"dp": 256, "tp": 1, "zero1": True,
                          "param_dtype": "bfloat16", "grad_compress": "int8",
                          "attn_impl": "flash", "overlap_gradsync": True},
            },
        ],
    },
    "C:jamba-1.5-large-398b/train_4k": {
        "arch": "jamba-1.5-large-398b",
        "shape": "train_4k",
        "why": ("paper-representative: 398B-param checkpoint state (CR cost "
                "is the operational story) + collective-bound + over-HBM "
                "at fp32 baseline"),
        "iterations": [
            {
                "name": "C1-fit-fsdp-zero1-bf16",
                "hypothesis": (
                    "baseline does not fit: fp32 params+moments = "
                    "398e9·12B/16 ≈ 280GB/dev. bf16 params sharded over "
                    "dp too (FSDP) + ZeRO-1 moments: 3.1+12.4 ≈ 15.5GB/dev "
                    "— fits v5e; costs an extra param all-gather per pass"),
                "knobs": {"param_dtype": "bfloat16", "zero1": True,
                          "fsdp": True},
                "verify_compile": ["--fsdp", "--zero1",
                                   "--param-dtype", "bfloat16"],
            },
            {
                "name": "C2-int8-grads",
                "hypothesis": (
                    "grad RS at fp32 (P/16·4B·15/16 ≈ 93GB wire) dominates "
                    "collectives with TP psums; int8 grads cut it 4×"),
                "knobs": {"param_dtype": "bfloat16", "zero1": True,
                          "fsdp": True, "grad_compress": "int8"},
            },
            {
                "name": "C3-overlap-gradsync",
                "hypothesis": ("17.8s of backward compute can hide all "
                               "remaining grad wire"),
                "knobs": {"param_dtype": "bfloat16", "zero1": True,
                          "fsdp": True, "grad_compress": "int8",
                          "overlap_gradsync": True},
            },
            {
                "name": "C4-flash-attention",
                "hypothesis": ("attention layers (9/72) still stream "
                               "scores; flash trims the memory term"),
                "knobs": {"param_dtype": "bfloat16", "zero1": True,
                          "fsdp": True, "grad_compress": "int8",
                          "overlap_gradsync": True, "attn_impl": "flash"},
            },
        ],
    },
}


def run_cell_loop(key: str, spec: Dict[str, Any]) -> Dict[str, Any]:
    arch, shape = spec["arch"], spec["shape"]
    baseline = _run(arch, shape)
    log: List[Dict[str, Any]] = []
    prev = baseline
    for it in spec["iterations"]:
        knobs = dict(it["knobs"])
        dp = knobs.pop("dp", 16)
        tp = knobs.pop("tp", 16)
        pd = knobs.pop("param_dtype", None)
        md = knobs.pop("moe_dispatch", None)
        after = _run(arch, shape, dp=dp, tp=tp, param_dtype=pd,
                     moe_dispatch=md, **knobs)
        dom_before = prev["bottleneck"]
        delta = prev[f"t_{dom_before}"] - after[f"t_{dom_before}"]
        confirmed = after["roofline_fraction"] > prev["roofline_fraction"]
        log.append({
            "name": it["name"],
            "hypothesis": it["hypothesis"],
            "before": {k: prev[k] for k in (
                "t_compute", "t_memory", "t_collective", "bottleneck",
                "roofline_fraction")},
            "after": {k: after[k] for k in (
                "t_compute", "t_memory", "t_collective", "bottleneck",
                "roofline_fraction")},
            "dominant_term_delta_s": delta,
            "confirmed": bool(confirmed),
            "verify_compile": it.get("verify_compile"),
        })
        prev = after
    return {
        "cell": key, "why": spec["why"],
        "baseline": {k: baseline[k] for k in (
            "t_compute", "t_memory", "t_collective", "bottleneck",
            "roofline_fraction", "useful_flops_ratio")},
        "final": {k: prev[k] for k in (
            "t_compute", "t_memory", "t_collective", "bottleneck",
            "roofline_fraction", "useful_flops_ratio")},
        "speedup": (max(baseline["t_compute"], baseline["t_memory"],
                        baseline["t_collective"]) /
                    max(prev["t_compute"], prev["t_memory"],
                        prev["t_collective"])),
        "iterations": log,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="reports/perf/perf_log.json")
    args = ap.parse_args()
    results = [run_cell_loop(k, v) for k, v in CELLS.items()]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1, default=float)
    for r in results:
        print(f"\n== {r['cell']} ({r['why']})")
        print(f"   baseline frac={r['baseline']['roofline_fraction']:.3f} "
              f"bound={r['baseline']['bottleneck']}")
        for it in r["iterations"]:
            mark = "✓" if it["confirmed"] else "✗"
            print(f"   {mark} {it['name']:24s} frac "
                  f"{it['before']['roofline_fraction']:.3f} → "
                  f"{it['after']['roofline_fraction']:.3f}  "
                  f"bound {it['before']['bottleneck']}→{it['after']['bottleneck']}")
        print(f"   final frac={r['final']['roofline_fraction']:.3f}  "
              f"speedup ×{r['speedup']:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
