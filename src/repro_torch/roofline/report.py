"""Regenerate analytic fields inside existing dry-run JSONs (keeps the
compile-derived memory/HLO diagnostics) and emit the EXPERIMENTS.md tables.

  PYTHONPATH=src python -m repro_torch.roofline.report refresh     # update JSONs
  PYTHONPATH=src python -m repro_torch.roofline.report tables      # print tables
"""
from __future__ import annotations

import glob
import json
import sys
from typing import Dict, List

from repro_torch.configs import SHAPE_BY_NAME, get_arch
from repro_torch.roofline.analytic import analytic_report


def refresh(pattern: str = "reports/dryrun/*.json") -> int:
    n = 0
    for p in sorted(glob.glob(pattern)):
        with open(p) as f:
            r = json.load(f)
        if r.get("status") != "ok":
            continue
        knobs = r.get("knobs", {})
        dp = 32 if r["mesh"] == "2x16x16" else 16
        tp = 16
        if knobs.get("dp_only"):
            dp, tp = dp * tp, 1
        import dataclasses
        cfg = get_arch(r["arch"])
        if knobs.get("param_dtype") and knobs["param_dtype"] != cfg.param_dtype:
            cfg = dataclasses.replace(cfg, param_dtype=knobs["param_dtype"])
        if knobs.get("moe_dispatch") and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, dispatch=knobs["moe_dispatch"]))
        ana = analytic_report(
            cfg, SHAPE_BY_NAME[r["shape"]], dp=dp, tp=tp,
            remat=knobs.get("remat", True), zero1=knobs.get("zero1", False),
            fsdp=knobs.get("fsdp", False))
        r.update(ana)
        with open(p, "w") as f:
            json.dump(r, f, indent=1, default=float)
        n += 1
    print(f"refreshed {n} reports")
    return 0


def _fmt(x, w=9, p=4):
    return f"{x:{w}.{p}f}"


def tables(pattern: str = "reports/dryrun/*.json") -> int:
    rows: List[Dict] = []
    for p in sorted(glob.glob(pattern)):
        rows.append(json.load(open(p)))
    for mesh_tag, title in (("16x16", "single-pod 16×16 (256 chips)"),
                            ("2x16x16", "multi-pod 2×16×16 (512 chips)")):
        print(f"\n### Roofline — {title}\n")
        print("| arch | shape | t_compute s | t_memory s | t_collective s |"
              " bound | useful | roofline frac | peak mem/dev |")
        print("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if r.get("mesh") != mesh_tag and not (
                    r.get("status") == "skipped" and mesh_tag == "16x16"
                    and r.get("mesh", "16x16") == "16x16"):
                continue
            if r.get("status") == "skipped":
                print(f"| {r['arch']} | {r['shape']} | — | — | — | N/A "
                      f"(skip: full attention) | — | — | — |")
                continue
            mem = r.get("peak_memory_per_device")
            mem_s = f"{mem / 2**30:.1f} GiB" if mem else "—"
            print(f"| {r['arch']} | {r['shape']} | {r['t_compute']:.4f} "
                  f"| {r['t_memory']:.4f} | {r['t_collective']:.4f} "
                  f"| {r['bottleneck']} | {r['useful_flops_ratio']:.3f} "
                  f"| {r['roofline_fraction']:.3f} | {mem_s} |")
    return 0


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "tables"
    raise SystemExit(refresh() if cmd == "refresh" else tables())
