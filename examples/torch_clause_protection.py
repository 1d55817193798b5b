"""Clause-carrying protection on the PyTorch port: per-subtree checkpoint
behavior.

The paper's clause system (``store(data) kind(DIFF)``, HDF5 format, dCP
granularity) as per-subtree ``Protect`` specs: params go differential and
int8-compressed, optimizer moments store FULL at bf16, the step scalar
rides along clause-less — all in ONE store call, one container.  On the
card the params' blocks are hashed by ``blockhash2``, their dirty blocks
packed by ``diffpack``, and a restart replays the DIFF links with
``diffunpack``.

Run:  PYTHONPATH=src python examples/torch_clause_protection.py            # on the card
      PYTHONPATH=src python examples/torch_clause_protection.py --device cpu
      (run it twice — the second run restarts from the checkpoint;
       inspect with: python -m repro_torch.tools.chkls --json \
           build/openchk-clauses/node-local/ckpts/ckpt-*/rank0.chk5)
"""
import argparse

import torch

from repro_torch.core.context import (
    CHK_DIFF,
    CheckpointConfig,
    CheckpointContext,
    Protect,
)


def init_state(dev: torch.device) -> dict:
    return {
        "params": {"w": torch.zeros(4096, device=dev)},
        "opt": {"m": torch.zeros(4096, device=dev),
                "v": torch.zeros(4096, device=dev)},
        "step": torch.tensor(0, dtype=torch.int32),
    }


def update(s):
    # touch only a slice of the params so the dCP dirty ratio stays low
    # (a fully-dirty tree promotes the delta back to FULL — Fig. 7)
    w = s["params"]["w"].clone()
    w[:256] += 0.1
    return {
        "params": {"w": w},
        "opt": {"m": s["opt"]["m"] * 0.9, "v": s["opt"]["v"] * 0.99},
        "step": s["step"] + 1,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/openchk-clauses")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "false: pass --device cpu to run on the CPU")

    state = init_state(dev)

    # synchronous stores so each StoreReport is returned inline (with a
    # CP-dedicated thread the report is deferred and store() returns None);
    # 1 KiB dCP blocks so the sliced update above is a genuinely sparse delta
    ctx = CheckpointContext(CheckpointConfig(dir=args.ckpt_dir,
                                             dedicated_thread=False,
                                             block_bytes=1024))
    ctx.protect(
        Protect("params/**", kind=CHK_DIFF, compress="int8", max_error=0.05),
        Protect("opt/**", format="chk5", precision="bf16"),
        Protect("step"),
    )
    state = ctx.load(state)

    start = int(state["step"])
    if ctx.restarted:
        print(f"transparent restart: resuming from step {start}")

    for t in range(start, 30):
        state = update(state)
        # params delta-encode against the previous store; opt is FULL bf16;
        # a mixed-kind container is written when the params delta is small
        ctx.store(state, id=t + 1, level=1, if_=(t + 1) % 10 == 0)

    rep = ctx.last_report
    if rep is not None:
        print(f"last store: kind={rep.kind} bytes={rep.bytes_payload:,} "
              f"dirty_ratio={rep.dirty_ratio}")
    ctx.shutdown()
    print(f"done at step {int(state['step'])}")
    print("inspect the container: python -m repro_torch.tools.chkls --json "
          f"{args.ckpt_dir}/node-local/ckpts/ckpt-*/rank0.chk5")


if __name__ == "__main__":
    main()
