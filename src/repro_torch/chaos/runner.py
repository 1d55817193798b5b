"""Chaos harness CLI: run the fault-scenario matrix, emit a JSON report.

    python -m repro_torch.chaos.runner --out report.json
    python -m repro_torch.chaos.runner --backend fti --scenario corrupt-chunk

Exit code 0 iff every (scenario × backend) cell passed with zero data
loss — the CI chaos lane gates on it.  The report is machine-readable:

    {"scenarios": [{"name": ..., "backend": ..., "ok": true,
                    "faults_fired": 2, "recovery_path": "partner",
                    "recovery_s": 0.04, "mttr_s": 0.04,
                    "data_loss_bytes": 0, "detail": {...}}, ...],
     "total": 24, "passed": 24, "data_loss_bytes": 0,
     "max_mttr_s": 0.31, "ok": true}

``--include-supervised`` adds the real multi-process kill/restart
scenario (spawns ``launch/train.py --supervise`` workers; slow).

The payloads live on ``--device`` (default ``cuda``): without a card the
command raises unless it gets ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.chaos.scenarios import (BACKENDS, SCENARIOS, SUPERVISED,
                                         check_device, run_matrix)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the payloads live (cuda needs a card)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh temp dir)")
    ap.add_argument("--backend", action="append", choices=BACKENDS,
                    help="restrict to backend(s); repeatable")
    ap.add_argument("--scenario", action="append",
                    choices=sorted(SCENARIOS) + sorted(SUPERVISED),
                    help="restrict to scenario(s); repeatable")
    ap.add_argument("--include-supervised", action="store_true",
                    help="also run the supervised multi-process "
                         "kill/restart scenario (slow)")
    ap.add_argument("--out", default=None, help="write JSON report here")
    ap.add_argument("--trace-dir", default=None,
                    help="record a perfetto trace per scenario cell into "
                         "this dir (<name>-<backend>.json); the report's "
                         "detail gains trace_file + a metrics snapshot")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    backends = tuple(args.backend) if args.backend else BACKENDS
    names = args.scenario or None
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    if args.workdir:
        report = run_matrix(args.workdir, backends, names,
                            include_supervised=args.include_supervised,
                            trace_dir=args.trace_dir, device=device)
    else:
        with tempfile.TemporaryDirectory(prefix="openchk-chaos-") as d:
            report = run_matrix(d, backends, names,
                                include_supervised=args.include_supervised,
                                trace_dir=args.trace_dir, device=device)

    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    for r in report["scenarios"]:
        print(f"[chaos] {'PASS' if r['ok'] else 'FAIL'} "
              f"{r['name']:<24s} {r['backend']:<6s} "
              f"via={r['recovery_path']:<10s} faults={r['faults_fired']} "
              f"loss={r['data_loss_bytes']}B mttr={r['mttr_s']:.3f}s")
    print(f"[chaos] {report['passed']}/{report['total']} passed, "
          f"total data loss {report['data_loss_bytes']} bytes, "
          f"max mttr {report['max_mttr_s']:.3f}s")
    if not report["ok"]:
        for r in report["scenarios"]:
            if not r["ok"]:
                print(f"[chaos] FAILED {r['name']}×{r['backend']}: "
                      f"{r['detail']}", file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
