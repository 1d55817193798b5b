"""Serving driver: batched decode with checkpointable engine state.

    python -m repro_torch.launch.serve --device cpu          # reduced, CPU
    python -m repro_torch.launch.serve --full                # on the card
    python -m repro_torch.launch.serve --follow-catalog file:<dir>/objstore

The PyTorch counterpart of ``repro.launch.serve``, with its flags plus
``--device`` (default ``cuda``: without a card the command raises unless
it gets ``--device cpu``) and ``--seed``.  The engine's (caches, pos,
last_token) tree is stored/loaded through the same directives, so a
failed server resumes generation without re-running prefill.  On a card
every op runs deterministically
(``train.step.use_deterministic_algorithms``), so a resumed run generates
what an uninterrupted one does.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (prompts: seed + 1)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/openchk-serve")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--kill-after", type=int, default=None,
                    help="simulate failure after N generated tokens")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--follow-catalog", default=None, metavar="URL",
                    help="object-store url (file:<dir> / mem:) to follow: "
                    "newly published FULL checkpoints hot-swap into the "
                    "engine between batches (checkpoint-as-deployment)")
    ap.add_argument("--deploy-cache", default=None,
                    help="node-local chunk/file cache for --follow-catalog "
                    "pulls (default <ckpt-dir>/deploy-cache)")
    ap.add_argument("--health-port", type=int, default=None,
                    help="serve /healthz /readyz /metrics for this replica "
                    "(0 = ephemeral); readiness follows weight swaps")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train.step import use_deterministic_algorithms

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch.cuda.is_available() "
                               "is false: pass --device cpu to serve on the "
                               "CPU")
        use_deterministic_algorithms()
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = ServingEngine(model, params, args.batch, args.max_len,
                        name="serve0")
    eng.swap_hook = lambda old, new: print(
        f"[serve] weights swapped: epoch {old.epoch} -> {new.epoch} "
        f"(catalog entry {new.entry_id})")

    health = None
    if args.health_port is not None:
        from repro_torch.telemetry.health import attach_engine
        health = attach_engine(eng, name="serve0", port=args.health_port)
        print(f"[serve] health endpoint on {health.server.url}")

    deployer = None
    if args.follow_catalog:
        from repro_torch.objstore.client import make_object_store
        from repro_torch.serve.deploy import FleetDeployer, Replica
        cache = args.deploy_cache or f"{args.ckpt_dir}/deploy-cache"
        deployer = FleetDeployer(
            make_object_store(args.follow_catalog),
            [Replica(name="serve0", engine=eng, cache_root=cache,
                     prefix="params", health=health)])

    ckpt = CheckpointContext(CheckpointConfig(dir=args.ckpt_dir,
                                              backend=args.backend))
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1),
        dtype=torch.int32).to(device)

    # transparent restart: if a serving checkpoint exists, skip prefill
    t0 = time.time()
    eng.prefill(prompts)
    restored = ckpt.load(eng.get_state())
    if ckpt.restarted:
        eng.set_state(restored)
        print(f"[serve] resumed at pos {int(restored.pos)} "
              f"(prefill skipped on restore path)")

    done = int(eng.get_state().pos) - args.prompt_len
    out = []
    for i in range(done, args.gen):
        if deployer is not None:
            st = deployer.poll()
            if st["action"] == "started":
                d = st["delta"]
                print(f"[serve] deploying catalog entry {st['entry']} "
                      f"(delta {d.n_chunks_delta}/{d.n_chunks_total} chunks, "
                      f"{d.bytes_delta}/{d.bytes_total} bytes)")
            elif st["action"] == "pinned":
                print(f"[serve] deploy pinned: {st['error']} "
                      f"(retrying with backoff)")
        out.append(eng.generate(1))
        if (i + 1) % 8 == 0:             # get_state copies the whole cache
            st = eng.get_state()
            ckpt.store(st, id=int(st.pos), level=1)
        if args.kill_after is not None and (i + 1) >= args.kill_after:
            ckpt.wait()
            print(f"[serve] simulated failure after {i + 1} tokens")
            ckpt.shutdown()
            return 39
    ckpt.wait()
    toks = torch.cat(out, dim=1) if out else torch.zeros((args.batch, 0))
    print(f"[serve] generated {toks.shape[1]} tokens/req in "
          f"{time.time() - t0:.1f}s; sample: {toks[0][:16].tolist()}")
    ckpt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
