"""Telemetry walkthrough on the PyTorch port: trace a store end to end,
read the metrics, probe a live health endpoint, and summarize the trace
with chktrace.

The telemetry plane is three stdlib-only pieces (``repro_torch.telemetry``):

- ``trace``   — process-wide span recorder exporting Chrome trace-event
  JSON (load the file at https://ui.perfetto.dev to see Plan → Pack →
  Place → Commit nested per thread, chunk uploads on the transfer pool);
- ``metrics`` — always-on counter/gauge/histogram registry with JSON
  snapshot and Prometheus text exposition;
- ``health``  — a real HTTP endpoint (/healthz /readyz /metrics) whose
  readiness follows the serving swap protocol.

Run:  PYTHONPATH=src python examples/torch_telemetry_trace.py            # on the card
      PYTHONPATH=src python examples/torch_telemetry_trace.py --device cpu
"""
import argparse
import json
import os
import urllib.error
import urllib.request

import numpy as np
import torch

from repro_torch.core.context import CheckpointConfig, CheckpointContext
from repro_torch.telemetry import metrics, trace
from repro_torch.telemetry.health import HealthServer, HealthState
from repro_torch.tools.chktrace import build_spans, store_critical_paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/openchk-telemetry")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "false: pass --device cpu to run on the CPU")
    trace_path = os.path.join(args.ckpt_dir, "trace.json")

    # --- 1. trace a real store ------------------------------------------- #
    # enable() here; production turns it on from outside via OPENCHK_TRACE=
    # <file> or OPENCHK_TRACE_DIR=<dir> (launch/train.py --trace-dir does
    # the latter so supervisor + restarted workers merge onto one timeline)
    trace.enable(trace_path)

    ctx = CheckpointContext(CheckpointConfig(
        dir=os.path.join(args.ckpt_dir, "ckpt"), backend="fti",
        dedicated_thread=False))
    state = {"params": {"w": torch.from_numpy(
        np.arange(1 << 20, dtype=np.float32)).to(dev)}}
    report = ctx.store(state, id=1, level=4)     # L4 → chunk uploads too
    ctx.shutdown()
    trace.flush()
    print(f"trace written: {trace_path}  (open in ui.perfetto.dev)")
    print(f"the report knows its span: StoreReport.span_id={report.span_id}")

    # --- 2. ask questions about the trace (what chktrace automates) ------ #
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    for row in store_critical_paths(build_spans(events)):
        print(f"store ckpt={row['ckpt_id']}: {row['dur_us'] / 1e3:.1f} ms, "
              f"dominant stage = {row['dominant_stage']}")
    print("same, from the CLI:  PYTHONPATH=src python -m "
          "repro_torch.tools.chktrace " + trace_path)

    # --- 3. the metrics the store fed ------------------------------------ #
    snap = metrics.snapshot()
    stores = snap["openchk_store_total"]["series"][0]
    print(f"openchk_store_total{stores['labels']} = {stores['value']}")
    print("prometheus text has",
          len(metrics.to_prometheus().splitlines()), "lines")

    # --- 4. a live health endpoint --------------------------------------- #
    # serving replicas get this wired automatically (attach_engine / the
    # --health-port flags on launch/serve.py and launch/train.py --supervise)
    health = HealthState(name="demo")
    srv = HealthServer(health).start()
    for ready in (False, True):
        health.set_ready(ready, epoch=1)
        try:
            with urllib.request.urlopen(srv.url + "/readyz", timeout=5) as r:
                code, body = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read().decode()
        print(f"/readyz while ready={ready}: HTTP {code} {body.strip()}")
    srv.stop()


if __name__ == "__main__":
    main()
