"""Differential checkpointing on the PyTorch port (paper §4.2.3): only
dirty blocks are written; past the ~95 % dirty break-even the engine
auto-promotes to FULL.  On the card the blocks are hashed and packed by
the ``blockhash2`` and ``diffpack`` kernels, and the restore replays the
DIFF with ``diffunpack``.

Run:  PYTHONPATH=src python examples/torch_differential_demo.py            # on the card
      PYTHONPATH=src python examples/torch_differential_demo.py --device cpu
"""
import argparse
import shutil

import numpy as np
import torch

from repro_torch.core.context import CHK_DIFF, CheckpointConfig, CheckpointContext


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/openchk-diff-example")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    rng = np.random.RandomState(0)
    state = {"params": torch.from_numpy(
        rng.randn(1 << 20).astype(np.float32)).to(dev),
        "step": torch.tensor(0, dtype=torch.int32)}

    ctx = CheckpointContext(CheckpointConfig(
        dir=args.ckpt_dir, backend="fti", block_bytes=16_384,
        dedicated_thread=False))

    rep = ctx.store(state, id=1, level=1)                    # base FULL
    print(f"id=1 FULL   {rep.bytes_payload:>10,d} B")

    # touch 1 % of the data in place → tiny delta
    state["params"][:10_000] += 1.0
    state["step"] += 1
    rep = ctx.store(state, id=2, level=1, kind=CHK_DIFF)
    print(f"id=2 {rep.kind:5s}  {rep.bytes_payload:>10,d} B "
          f"(dirty ratio {rep.dirty_ratio:.3f})")

    # touch everything → the engine promotes to FULL (95 % break-even)
    state["params"] += 1.0
    state["step"] += 1
    rep = ctx.store(state, id=3, level=1, kind=CHK_DIFF)
    print(f"id=3 {rep.kind:5s}  {rep.bytes_payload:>10,d} B "
          f"(dirty ratio {rep.dirty_ratio:.3f}, promoted={rep.promoted_full})")
    ctx.shutdown()

    # restore replays base + deltas exactly, onto the template's device
    ctx2 = CheckpointContext(CheckpointConfig(dir=args.ckpt_dir,
                                              backend="fti"))
    got = ctx2.load({"params": torch.zeros(1 << 20, device=dev),
                     "step": torch.tensor(0, dtype=torch.int32)})
    assert int(got["step"]) == 2
    assert torch.equal(got["params"], state["params"])
    print(f"replayed restore exact on {got['params'].device}")
    ctx2.shutdown()


if __name__ == "__main__":
    main()
