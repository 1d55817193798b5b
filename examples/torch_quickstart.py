"""Quickstart on the PyTorch port: the OpenCHK directives on a toy loop.

The paper's full CR surface is five lines (§6.3):
    init (2: config + context), load (1), store (1), shutdown (1).

Run:  PYTHONPATH=src python examples/torch_quickstart.py            # on the card
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
      (run it twice — the second run restarts from the checkpoint)
"""
import argparse

import torch

from repro_torch.core.context import CheckpointConfig, CheckpointContext


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/openchk-quickstart")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- application state: any tree of tensors ---------------------------
    state = {"step": torch.tensor(0, dtype=torch.int32),
             "w": torch.zeros(16, device=dev)}

    def update(s):
        return {"step": s["step"] + 1, "w": s["w"] + 0.1}

    # --- the five CR lines ------------------------------------------------
    cfg = CheckpointConfig(dir=args.ckpt_dir)                     # 1 (config)
    ctx = CheckpointContext(cfg)                                  # 2 (chk init)
    state = ctx.load(state)                                       # 3 (chk load)

    start = int(state["step"])
    if ctx.restarted:
        print(f"transparent restart: resuming from step {start}")

    for t in range(start, 50):
        state = update(state)
        ctx.store(state, id=t + 1, level=1,
                  if_=(t + 1) % 10 == 0)                          # 4 (chk store)

    ctx.shutdown()                                                # 5 (chk shutdown)
    print(f"done at step {int(state['step'])}, "
          f"w[0]={float(state['w'][0]):.2f} on {state['w'].device}")
    print(f"run me again to see the restart path; rm -rf {args.ckpt_dir} "
          f"to reset")


if __name__ == "__main__":
    main()
