"""End-to-end training entry point with OpenCHK checkpoint/restart.

Modes:
  direct:      python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 200
  supervised:  python -m repro_torch.launch.train --supervise --inject-at 0.9 ...
               (launcher spawns the worker, injects a fault at 90 % progress,
               detects death via exit code / heartbeat timeout, restarts; the
               worker resumes from the last checkpoint via ``ctx.load`` — the
               paper's §6.1 methodology end to end)

The PyTorch counterpart of ``repro.launch.train``, with its flags,
``--device``, ``--keep-last-full`` (the FULLs each tier keeps) and
``--launch-counts`` (the worker's kernel launches, written when it
ends).  The default device is ``cuda``: without a card the command raises
unless it gets ``--device cpu``.  On a card every op runs
deterministically (``train.step.use_deterministic_algorithms``), so a
resumed run ends bit-equal to an uninterrupted one.  The step donates its
state (``make_train_step(donate=True)``: parameters and moments updated in
place), so granite-moe-3b-a800m's 39.6 GB ``TrainState`` trains on one
80 GB card.  Reduced configs run on the CPU; ``--full`` uses the published
widths.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def worker(args) -> int:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.data.synthetic import init_data_state
    from repro_torch.ft.failures import FaultInjector, should_inject_from_env
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import LevelSchedule, LoopConfig, run_training
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import init_train_state, prng_key
    from repro_torch.train.step import (make_train_step,
                                        use_deterministic_algorithms)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch.cuda.is_available() "
                               "is false: pass --device cpu to train on the "
                               "CPU")
        use_deterministic_algorithms()
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    step_fn = make_train_step(
        model, AdamWConfig(total_steps=args.steps, warmup_steps=args.steps // 10),
        remat=not args.no_remat, num_microbatches=args.microbatches,
        donate=True)

    ckpt = CheckpointContext(CheckpointConfig(
        dir=args.ckpt_dir, backend=args.backend,
        keep_last_full=args.keep_last_full,
        dedicated_thread=not args.no_dedicated_thread))

    inject_at = args.inject_at if args.inject_at else should_inject_from_env()
    injector = FaultInjector(args.steps, inject_at, hard=args.hard_fault) \
        if inject_at else None

    cadence = None
    if args.cadence:
        from repro_torch.chaos.cadence import (
            CadenceConfig, CadenceController, MTBFFeed)
        cadence = CadenceController(CadenceConfig(
            prior_mtbf_s=args.cadence_mtbf,
            gap_failure_s=args.heartbeat_timeout))
        MTBFFeed(os.path.join(args.ckpt_dir, "mtbf-feed.json")).seed(
            cadence.mtbf)

    loop = LoopConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        kind="DIFF" if args.differential else "FULL",
        levels=LevelSchedule(),
        heartbeat_path=os.path.join(args.ckpt_dir, "heartbeat"),
        cadence=cadence,
        gap_failure_s=args.heartbeat_timeout,
    )
    try:
        # the state is built in the call, so no name here keeps it (or,
        # after a restart, the template ckpt.load restored over) alive
        summary = run_training(
            model, step_fn,
            init_train_state(
                model.init(torch.Generator(device=device).manual_seed(
                    args.seed)),
                prng_key(args.seed + 1), init_data_state(args.seed)),
            ckpt, loop, args.batch, args.seq, injector=injector)
    finally:
        ckpt.shutdown()
    brief = {k: v for k, v in summary.items() if k != "state"}
    print(f"[train] done: {brief}")
    if args.launch_counts:
        from repro_torch.kernels.ops import launch_counts
        path = os.path.join(args.ckpt_dir, f"launches-{os.getpid()}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(launch_counts(), f)
    return 0


def supervise(args) -> int:
    """Restart launcher: run the worker until success, restarting on
    failure (:class:`repro_torch.ft.supervisor.Supervisor`).  Chaos specs
    survive restarts with spec-declared ``rearm`` semantics: their durable
    counters (``OPENCHK_CHAOS_STATE``, defaulted into the checkpoint dir)
    keep an exhausted kill spec from re-killing every restarted child."""
    from repro_torch.chaos import inject
    from repro_torch.ft.supervisor import Supervisor, SupervisorConfig

    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + [
        a for a in sys.argv[1:] if a not in ("--supervise",)]
    env = dict(os.environ)
    if args.inject_at:
        env["OPENCHK_INJECT_AT"] = str(args.inject_at)
        cmd = [c for c in cmd if not c.startswith("--inject-at")
               and c != str(args.inject_at)]
    if env.get(inject.CHAOS_ENV) and not env.get(inject.CHAOS_STATE_ENV):
        env[inject.CHAOS_STATE_ENV] = os.path.join(
            args.ckpt_dir, "chaos-state.json")
    sup = Supervisor(cmd, env, SupervisorConfig(
        heartbeat_path=os.path.join(args.ckpt_dir, "heartbeat"),
        heartbeat_timeout_s=args.heartbeat_timeout,
        startup_grace_s=args.startup_grace,
        healthy_reset_s=args.healthy_reset,
        max_restarts=args.max_restarts,
        backoff_base_s=args.restart_backoff,
        backoff_max_s=args.restart_backoff_max,
        mtbf_feed_path=os.path.join(args.ckpt_dir, "mtbf-feed.json"),
        prior_mtbf_s=args.cadence_mtbf,
        health_port=args.health_port,
    ))
    return sup.run()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/openchk-train")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--backend", default=None, help="fti|scr|veloc (or env)")
    ap.add_argument("--differential", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: a reduced config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="a cut of the config's depth, its widths kept "
                         "(default: all its layers)")
    ap.add_argument("--keep-last-full", type=int, default=2,
                    help="committed FULL checkpoints kept on each tier "
                         "(older ids and their DIFF chains are deleted)")
    ap.add_argument("--launch-counts", action="store_true",
                    help="when training ends, write this process's kernel "
                         "launches to <ckpt-dir>/launches-<pid>.json")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-dedicated-thread", action="store_true")
    ap.add_argument("--inject-at", type=float, default=None)
    ap.add_argument("--hard-fault", action="store_true",
                    help="os._exit instead of exception")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--heartbeat-timeout", type=float, default=120.0)
    ap.add_argument("--restart-backoff", type=float, default=1.0,
                    help="base seconds between restart attempts (doubles "
                         "per consecutive failure)")
    ap.add_argument("--restart-backoff-max", type=float, default=30.0)
    ap.add_argument("--startup-grace", type=float, default=None,
                    help="kill a worker that never beats within this many "
                         "seconds (default: 2x --heartbeat-timeout)")
    ap.add_argument("--healthy-reset", type=float, default=None,
                    help="forget restart-backoff failures after the worker "
                         "stays healthy this long (default: "
                         "--heartbeat-timeout)")
    ap.add_argument("--cadence", action="store_true",
                    help="Daly-optimal adaptive checkpoint cadence instead "
                         "of the fixed --ckpt-every cycle")
    ap.add_argument("--cadence-mtbf", type=float, default=3600.0,
                    help="prior MTBF seconds for the cadence controller")
    ap.add_argument("--trace-dir", default=None,
                    help="write perfetto trace files (trace-<pid>.json) "
                         "into this dir; under --supervise the supervisor "
                         "merges worker files into one trace.json")
    ap.add_argument("--health-port", type=int, default=None,
                    help="with --supervise: serve /healthz /readyz "
                         "/metrics on this port (0 = ephemeral)")
    args = ap.parse_args()
    os.makedirs(args.ckpt_dir, exist_ok=True)
    if args.trace_dir:
        # env, not a direct enable: the worker subprocesses a supervisor
        # spawns inherit it (each process writes trace-<pid>.json)
        os.makedirs(args.trace_dir, exist_ok=True)
        os.environ["OPENCHK_TRACE_DIR"] = args.trace_dir
    if args.supervise:
        return supervise(args)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
