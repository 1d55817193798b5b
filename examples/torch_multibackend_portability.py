"""Portability on the PyTorch port (paper §6.3): identical application code
runs on FTI, SCR, or VeloC — the backend comes from OPENCHK_BACKEND, zero
source changes.

Run:  PYTHONPATH=src python examples/torch_multibackend_portability.py            # on the card
      PYTHONPATH=src python examples/torch_multibackend_portability.py --device cpu
"""
import argparse
import os
import shutil

import torch

from repro_torch.core.context import CheckpointConfig, CheckpointContext


def application(ckpt_dir: str, dev: torch.device) -> dict:
    """The app: no backend name anywhere in this function."""
    state = {"x": torch.zeros(8, device=dev),
             "step": torch.tensor(0, dtype=torch.int32)}
    ctx = CheckpointContext(CheckpointConfig(dir=ckpt_dir))
    state = ctx.load(state)
    for t in range(int(state["step"]), 20):
        state = {"x": state["x"] + 1.0,
                 "step": torch.tensor(t + 1, dtype=torch.int32)}
        ctx.store(state, id=t + 1, level=1, if_=(t + 1) % 5 == 0)
    ctx.wait()
    stats = dict(ctx.stats)
    ctx.shutdown()
    return {"x0": float(state["x"][0]), "restarted": ctx.restarted,
            "stats": stats}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/openchk-port")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "false: pass --device cpu to run on the CPU")
    for backend in ("fti", "scr", "veloc"):
        d = os.path.join(args.ckpt_dir, backend)
        shutil.rmtree(d, ignore_errors=True)
        os.environ["OPENCHK_BACKEND"] = backend      # the ONLY difference
        first = application(d, dev)
        again = application(d, dev)                  # restart path
        print(f"{backend:6s} x0={first['x0']:.0f} "
              f"restart-detected={again['restarted']} stats={first['stats']}")
        shutil.rmtree(d, ignore_errors=True)
    print("same source, three backends ✓")


if __name__ == "__main__":
    main()
