"""Resilient serving on the PyTorch port: checkpoint the decode state,
kill the server, resume generation without re-running prefill.

Run:  PYTHONPATH=src python examples/torch_serve_resilient.py            # on the card
      PYTHONPATH=src python examples/torch_serve_resilient.py --device cpu
"""
import argparse
import shutil

import torch

from repro_torch.configs import get_arch
from repro_torch.core.context import CheckpointConfig, CheckpointContext
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import ServeState, ServingEngine, WeightsHandle
from repro_torch.train.step import use_deterministic_algorithms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/openchk-serve-example")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        use_deterministic_algorithms()     # resumed == uninterrupted
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    cfg = get_arch("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 12), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)
                            ).to(dev)

    # server #1: prefill, generate 10 tokens, checkpoint, "crash".
    # Weights are an explicit epoch-tagged handle — set_weights is the
    # only mutation path (the deploy subscriber swaps through it too)
    eng = ServingEngine(model, WeightsHandle(params=params), batch=2,
                        max_len=64)
    eng.prefill(prompts)
    first = eng.generate(10)
    ctx = CheckpointContext(CheckpointConfig(dir=args.ckpt_dir))
    ctx.store(eng.get_state(), id=int(eng.get_state().pos), level=1)
    ctx.wait()
    ctx.shutdown()
    print(f"server 1 generated: {first[0].tolist()} … crash!")

    # server #2: fresh engine — restore, NO prefill, continue.  The
    # weights arrive via the one mutation path: an atomic handle swap
    eng2 = ServingEngine(model, model.init(
        torch.Generator(device=dev).manual_seed(9)), batch=2, max_len=64)
    swapped = eng2.set_weights(WeightsHandle(params=params))
    assert eng2.weights.epoch == swapped.epoch > 0
    cold = ServeState(caches=model.init_caches(2, 64, device=dev),
                      pos=torch.tensor(0, dtype=torch.int32),
                      last_token=torch.zeros((2, 1), dtype=torch.int32,
                                             device=dev))
    ctx2 = CheckpointContext(CheckpointConfig(dir=args.ckpt_dir))
    restored = ctx2.load(cold)
    assert ctx2.restarted, "no serving checkpoint found"
    eng2.set_state(restored)
    ctx2.shutdown()
    more = eng2.generate(10)
    print(f"server 2 resumed at pos {int(restored.pos)}, "
          f"continued: {more[0].tolist()}")

    # ground truth: uninterrupted generation matches
    eng3 = ServingEngine(model, params, batch=2, max_len=64)
    eng3.prefill(prompts)
    full = eng3.generate(20)
    assert torch.equal(full[:, 10:], more), "divergence after restore!"
    print(f"resumed continuation matches uninterrupted generation on {dev}")


if __name__ == "__main__":
    main()
