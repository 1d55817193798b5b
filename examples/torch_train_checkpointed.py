"""End-to-end driver on the PyTorch port: train an LM with
checkpoint/restart, fault included.

Default: reduced tinyllama (CPU-friendly, ~1 min). The full-scale flow —
supervision, heartbeats, restart loop — is the same code path used by
``python -m repro_torch.launch.train --supervise`` (see that module); pass
``--hundred-m`` for a ~100M-parameter llama-family config if you have the
compute budget (same code, bigger dims).  ``REPRO_ATTN_IMPL=flash`` takes
the flash attention kernel on the card.

Run:  PYTHONPATH=src python examples/torch_train_checkpointed.py            # on the card
      PYTHONPATH=src python examples/torch_train_checkpointed.py --device cpu
"""
import argparse
import dataclasses
import shutil

import torch

from repro_torch.configs import get_arch
from repro_torch.core.context import CheckpointConfig, CheckpointContext
from repro_torch.data.synthetic import init_data_state
from repro_torch.ft.failures import FaultInjector, SimulatedFault
from repro_torch.models.zoo import build_model
from repro_torch.train.loop import LevelSchedule, LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.state import init_train_state, prng_key
from repro_torch.train.step import (make_train_step,
                                    use_deterministic_algorithms)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--differential", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/openchk-train-example")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but torch.cuda.is_available() "
                             "is false: pass --device cpu to run on the CPU")
        use_deterministic_algorithms()     # resumed == uninterrupted
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = get_arch("tinyllama-1.1b").reduced()
    if args.hundred_m:    # ~100M params, same family
        cfg = dataclasses.replace(
            cfg, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_head=64, d_ff=2048, vocab_size=32_000)
    model = build_model(cfg)
    print(f"params ≈ {cfg.param_count() / 1e6:.1f}M")

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(params, prng_key(1), init_data_state())
    step = make_train_step(model, AdamWConfig(total_steps=args.steps,
                                              warmup_steps=5))
    loop = LoopConfig(total_steps=args.steps, ckpt_every=10,
                      kind="DIFF" if args.differential else "FULL",
                      levels=LevelSchedule())

    # attempt 1: fault at 90 % progress (paper §6.1 methodology)
    ctx = CheckpointContext(CheckpointConfig(dir=args.ckpt_dir))
    inj = FaultInjector(args.steps, at_progress=0.9)
    try:
        run_training(model, step, state, ctx, loop, 8, 64, injector=inj)
    except SimulatedFault as e:
        print(f"!! {e}")
    finally:
        ctx.shutdown()

    # attempt 2: transparent restart → completion
    ctx2 = CheckpointContext(CheckpointConfig(dir=args.ckpt_dir))
    out = run_training(model, step, state, ctx2, loop, 8, 64)
    ctx2.shutdown()
    print(f"finished: step={out['final_step']} loss={out['loss']:.4f} "
          f"restarted={out['restarted']} backend_stats={out['stats']}")


if __name__ == "__main__":
    main()
