"""The readings the limits of ``correct`` are set from, at a cell's own
size, on the card, in one process (the benchmark's runs never run this):

- the program: its first steps (as a run's set-up takes them) against the
  plain reference, on every seed;
- the control: the reference in the program's place, its products in
  float8 e4m3, one step below the configuration's bfloat16, against the
  reference, on the first ``--faults`` seeds;
- a witness: the reference rounded to bfloat16 where the program rounds,
  what the stated precision alone costs, on the same seeds;
- a planted fault: half of each batch left out, the mean taken over the
  rest, on the same seeds.  (A state left unchanged reads 1 on
  ``grad_gap`` and ``change_gap`` by construction, and needs no run.)

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--faults 3] [--out <file.json>]
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import check, harness, spec  # noqa: E402


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run(args.workload, [int(s) for s in args.seeds.split(",")],
              args.faults, device)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
    print(text)
    return 0


def run(workload, seeds, faults, device, shrink=None) -> dict:
    import torch
    bench = spec.load()
    cell = spec.cell(bench, workload)
    rows = []
    for i, seed in enumerate(seeds):
        t = time.time()
        row = {"seed": seed}
        setup = harness.prepare(bench, cell, seed, device, shrink=shrink)
        state, prog = harness.first_steps(setup)
        del state
        _free(torch, device)
        ref = harness.reference_readings(setup, "f32")
        row["program"] = check.training_numbers(prog, ref)
        row["detail"] = {"program": _detail(prog, ref)}
        if i < faults:
            ctl = harness.reference_readings(setup, "fp8")
            row["control"] = check.training_numbers(ctl, ref)
            row["detail"]["control"] = _detail(ctl, ref)
            wit = harness.reference_readings(setup, "bf16")
            row["bf16_witness"] = check.training_numbers(wit, ref)
            row["detail"]["bf16_witness"] = _detail(wit, ref)
            setup = harness.prepare(bench, cell, seed, device, shrink=shrink,
                                    fault="half_batch")
            state, half = harness.first_steps(setup)
            del state
            _free(torch, device)
            row["half_batch"] = check.training_numbers(half, ref)
        setup = None
        _free(torch, device)
        row["seconds"] = time.time() - t
        print(json.dumps({k: v for k, v in row.items() if k != "detail"}),
              file=sys.stderr, flush=True)
        rows.append(row)
    return {"workload": workload, "rows": rows,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "power": harness.power_limit() if device.type == "cuda" else ""}


def _detail(got, ref) -> dict:
    """Each step's loss gap and each leaf's gradient and change gaps."""
    return {"loss": [abs(p - r) / abs(r)
                     for p, r in zip(got["loss"], ref["loss"])],
            "grad": check.leaf_gaps(got["grad"], ref["grad"]),
            "change": check.leaf_gaps(got["change"], ref["change"],
                                      check.counted_leaves(ref["grad"]))}


def _free(torch, device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
