"""One run of one cell: set-up, the measured window, the check of
``correct``, the metrics, and the result's line.

The window plays the user's program: a training loop over the program's
``make_train_step`` (remat, a donated state) with the checkpoint
directives around it, as the traffic file schedules them:

- ``store``: at the first step boundary after ``at_window_share`` of the
  window, one ``ctx.store(state, id=step, level=..., kind=...)``; training
  goes on while the CP thread packs and commits;
- ``fault: after_commit``: at the first step boundary after that commit,
  the state is dropped and the context shut down, as a fault would leave
  them, and a fresh context restores the newest checkpoint into a
  template that holds no device memory; training goes on from there.

The window ends at the first step boundary past ``--seconds`` at which
the schedule is done.  Set-up makes the weights and a pool of batches on
the device from the seed, and runs the first three steps through the
window's own step (the warm-up, and the readings ``correct`` compares
with the plain reference after the window).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional

from perfbench import check, devtrace, inputs, spec

SETUP_STEPS = 3
#: top-level module names that may not be loaded in a run's process: JAX,
#: and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def _get(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _set(arch, values: Dict):
    top = {k: v for k, v in values.items() if "." not in k}
    for k, v in values.items():
        if "." in k:
            head, tail = k.split(".", 1)
            sub = top.get(head, getattr(arch, head))
            top[head] = dataclasses.replace(sub, **{tail: v})
    return dataclasses.replace(arch, **top)


def port_arch(cfg: Dict, exact: bool = True):
    """The program's ``ArchConfig`` for a configuration file: its
    registered arch with ``port.replace`` applied; every ``port.match``
    field must then equal the file's key.  ``exact`` false (a shrunken
    configuration in the tests) sets every matched field from the file."""
    from repro_torch.configs import get_arch
    p = cfg["port"]
    arch = _set(get_arch(p["arch"]),
                {f: cfg[k] for f, k in p["replace"].items()})
    if not exact:
        arch = _set(arch, {f: cfg[k] for f, k in p["match"].items()})
        arch = dataclasses.replace(arch, d_head=None,
                                   compute_dtype=cfg["compute_dtype"],
                                   param_dtype=cfg["param_dtype"])
    for f, k in p["match"].items():
        if _get(arch, f) != cfg[k]:
            raise ValueError(f"{cfg['name']}: the program's {f} is "
                             f"{_get(arch, f)!r}, the file's {k} {cfg[k]!r}")
    for f in ("compute_dtype", "param_dtype"):
        if getattr(arch, f) != cfg[f]:
            raise ValueError(f"{cfg['name']}: the program's {f} is "
                             f"{getattr(arch, f)}, the file's {cfg[f]}")
    return arch


def bytes_written() -> int:
    """Bytes this process has handed to ``write`` calls so far (``wchar`` of
    ``/proc/self/io``: files, pipes and sockets alike, so an upper bound on
    what it wrote to disk)."""
    try:
        with open("/proc/self/io", encoding="ascii") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Run:
    """What one run observed; the metric readers read it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def prepare(bench: Dict, cell: Dict, seed: int, device, *,
            shrink: Optional[Callable] = None,
            fault: Optional[str] = None) -> Dict:
    """The cell's files, the program's model and donated training step, the
    seed's pool of batches on ``device``, and the program's state made
    from the seed's weights."""
    import torch

    cfg = spec.config(bench, cell["config"])
    tr = spec.traffic(cell["traffic"])
    job = spec.job(cfg, tr)
    if shrink is not None:
        cfg, job = shrink(cfg, job)
    fam = spec.reference(cfg["reference"])
    os.environ["REPRO_ATTN_IMPL"] = job["attention"]

    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.data.synthetic import init_data_state
    from repro_torch.models.zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.state import init_train_state, prng_key
    from repro_torch.train.step import (make_train_step,
                                        use_deterministic_algorithms)

    if device.type == "cuda":
        use_deterministic_algorithms()
    written0 = bytes_written()
    model = build_model(port_arch(cfg, exact=shrink is None))
    struct = model.param_struct()
    shapes = {k: tuple(v.shape) for k, v in flatten_named(struct).items()}
    pool = inputs.make_batches(
        fam.batch_shapes(cfg, job), fam.dims(cfg)["V"], tr["batch_pool"],
        seed, device, getattr(torch, cfg["compute_dtype"]))
    state = init_train_state(
        unflatten_named(inputs.make_weights(shapes, seed, device), struct),
        prng_key(seed), init_data_state(int(seed) & 0xFFFFFFFF))
    step_fn = make_train_step(model, AdamWConfig(**job["optimizer"]),
                              remat=job["remat"], donate=True)
    return {"cfg": cfg, "job": job, "traffic": tr, "family": fam,
            "shapes": shapes, "pool": pool, "state": state, "seed": seed,
            "device": device, "written0": written0,
            "step_fn": _planted(step_fn, fault)}


def first_steps(setup: Dict):
    """The first ``SETUP_STEPS`` steps through the window's own step, on
    batches whose rows all differ → (state, readings): each step's loss,
    the first gradient as the optimizer got it (from the first moment,
    m / (1 - b1)) and the parameters' change over the steps, by leaf."""
    from repro_torch.core.protect import flatten_named

    state, step_fn, pool = setup["state"], setup["step_fn"], setup["pool"]
    setup["state"] = None
    b1 = setup["job"]["optimizer"]["b1"]
    prog = {"loss": []}
    for i in range(SETUP_STEPS):
        state, met = step_fn(state, pool[int(state.step) % len(pool)])
        prog["loss"].append(float(met["loss"]))
        if i == 0:
            prog["grad"] = {k: float(v.double().norm()) / (1 - b1) for k, v
                            in flatten_named(state.opt.mu).items()}
    w0 = inputs.make_weights(setup["shapes"], setup["seed"], setup["device"])
    now = flatten_named(state.params)
    prog["change"] = {k: float((now[k] - w0[k]).double().norm())
                      for k in w0}
    return state, prog


def reference_readings(setup: Dict, products: str) -> Dict:
    """The plain reference's first steps on the same weights and batches,
    products in ``"f32"`` (the reference) or ``"fp8"`` (the control) →
    the readings ``first_steps`` gives of the program."""
    import torch
    from perfbench.reference.common import Precision, strict_f32, train_steps

    if setup["device"].type == "cuda":
        torch.use_deterministic_algorithms(False)
    strict_f32()
    cfg, job, fam = setup["cfg"], setup["job"], setup["family"]
    w = inputs.make_weights(setup["shapes"], setup["seed"], setup["device"])
    pr = Precision(products)
    got = train_steps(lambda p, b: fam.forward_blocks(p, b, cfg, job, pr),
                      w, setup["pool"][:SETUP_STEPS], job["optimizer"])
    w0 = inputs.make_weights(setup["shapes"], setup["seed"], setup["device"])
    return {"loss": got["loss"], "grad": got["grad_norms"][0],
            "change": {k: float((w[k] - w0[k]).double().norm())
                       for k in w0}}


def run_cell(bench: Dict, cell: Dict, seed: int, seconds: float,
             trace: bool, device, t0: float, *, workdir: Path,
             shrink: Optional[Callable] = None,
             fault: Optional[str] = None) -> Dict:
    """One run → the result's fields.  ``shrink`` (tests: a small
    configuration on the CPU) and ``fault`` (tests: a planted fault, one of
    ``unchanged``, ``half_batch``, ``corrupt_restore``) are never set by
    the benchmark's own runs."""
    import torch

    setup = prepare(bench, cell, seed, device, shrink=shrink, fault=fault)
    cfg, job, tr, fam = (setup[k] for k in ("cfg", "job", "traffic",
                                                 "family"))
    shapes, pool, opt = setup["shapes"], setup["pool"], job["optimizer"]
    step_fn = setup["step_fn"]
    on_card = device.type == "cuda"
    written0 = setup["written0"]

    from repro_torch.core.context import CheckpointConfig, CheckpointContext
    from repro_torch.core.protect import flatten_named, unflatten_named
    from repro_torch.telemetry import trace as ttrace

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def batch_of(st):
        return pool[int(st.step) % len(pool)]

    state, prog = first_steps(setup)
    if on_card:
        from repro_torch.kernels.blockhash import blockhash2
        blockhash2(torch.zeros(1 << 14, dtype=torch.int32, device=device),
                   65536)
    store_cfg = tr.get("store")
    ckpt_root = workdir / "ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    template = ctx = None
    committed = threading.Event()
    reports = []

    def on_report(r):
        reports.append((time.time(), r))
        committed.set()

    def new_context():
        return CheckpointContext(CheckpointConfig(
            dir=str(ckpt_root), backend=store_cfg["backend"],
            dedicated_thread=store_cfg["dedicated_thread"], objstore=False))

    if store_cfg is not None:
        template = unflatten_named(
            {k: (v.new_empty(()).expand(v.shape) if v.is_cuda else v.clone())
             for k, v in flatten_named(state).items()}, state)
        ctx = new_context().observe_store_reports(on_report)
    gc.collect()
    sync()
    dt = devtrace.DeviceTrace(trace, device.type)
    if trace:
        ttrace.reset()
        ttrace.enable()
    setup_s = time.time() - t0
    log(f"set-up {setup_s:.3f} s; {cfg['name']} at step {int(state.step)}, "
        f"losses {prog['loss']}")

    # ------------------------------------------------------------------ #
    # the window
    # ------------------------------------------------------------------ #
    dt.start()
    step0 = int(state.step)
    first_loss: Dict[int, float] = {}
    replayed: Dict[int, float] = {}
    step_times, stores, snapshot = [], [], None
    recover_s = restore_mismatch = None
    phase = "train" if store_cfg is None else "before_store"
    deadline = seconds + 180.0
    with dt.mark("window"):
        t_start = time.time()
        while True:
            elapsed = time.time() - t_start
            if phase == "before_store" and \
                    elapsed >= store_cfg["at_window_share"] * seconds:
                sid = int(state.step)
                snapshot = {k: v.clone()
                            for k, v in flatten_named(state).items()}
                with dt.mark("store"):
                    t = time.time()
                    ctx.store(state, id=sid, level=store_cfg["level"],
                              kind=store_cfg["kind"])
                    stores.append({"id": sid, "call_t": t,
                                   "call_s": time.time() - t})
                phase = "stored"
            elif phase == "stored" and committed.is_set():
                if tr.get("fault") != "after_commit":
                    phase = "done"
                else:
                    with dt.mark("recover"):
                        t = time.time()
                        state = None
                        ctx.shutdown()
                        ctx = new_context()
                        state = ctx.load(template)
                        sync()
                        recover_s = time.time() - t
                    if not ctx.restarted:
                        raise RuntimeError("the restart found no checkpoint")
                    if fault == "corrupt_restore":
                        leaf = flatten_named(state.params)["embed"]
                        leaf.view(-1)[0] += 1
                    got = flatten_named(state)
                    restore_mismatch = sum(not torch.equal(got[k], v)
                                           for k, v in snapshot.items())
                    snapshot = got = None
                    phase = "done"
            if elapsed >= seconds and phase in ("train", "done"):
                break
            if elapsed >= deadline:
                raise RuntimeError(f"the schedule did not end within "
                                   f"{deadline:.0f} s (phase {phase})")
            with dt.mark("step"):
                t = time.time()
                n = int(state.step) + 1
                state, met = step_fn(state, batch_of(state))
                loss = float(met["loss"])          # the user reads the loss
                step_times.append(time.time() - t)
            (replayed if n in first_loss else first_loss)[n] = loss
        sync()
        window_s = time.time() - t_start
    dt.stop()
    if trace:
        ttrace.disable()
    final_step = int(state.step)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    events = ttrace.tracer().events() if trace else []
    if ctx is not None:
        ctx.shutdown()
    state = template = ctx = snapshot = None
    shutil.rmtree(ckpt_root, ignore_errors=True)
    written = bytes_written() - written0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reduced = dt.reduce()
    dt = None
    commit_t = reports[0][0] if reports else None
    log(f"window {window_s:.3f} s: steps {step0} -> {final_step}, "
        f"{len(step_times)} run, stores {[s['id'] for s in stores]}, "
        f"store_call_s {[s['call_s'] for s in stores]}, commit_s "
        f"{[commit_t - s['call_t'] for s in stores] if commit_t else None}, "
        f"recover_s {recover_s}; bytes written by the run {written}")

    # ------------------------------------------------------------------ #
    # the plain reference, after the window, on the same inputs
    # ------------------------------------------------------------------ #
    t = time.time()
    ref = reference_readings(setup, "f32")
    del pool
    setup = None
    numbers = check.training_numbers(prog, ref)
    if store_cfg is not None and tr.get("fault") == "after_commit":
        numbers["restore_mismatch"] = restore_mismatch
        numbers["replay_mismatch"] = sum(
            replayed[k] != first_loss[k] for k in replayed)
    ok, checks = check.judge(numbers, spec.limits(cfg["name"]))
    log(f"reference: {time.time() - t:.3f} s; losses {ref['loss']} "
        f"against the program's {prog['loss']}")

    run = Run(
        cfg=cfg, job=job, traffic=tr, family=fam, seconds=seconds,
        setup_s=setup_s, window_s=window_s, step0=step0,
        final_step=final_step, loss_tokens=fam.loss_tokens(cfg, job),
        step_times=step_times, model_flops=fam.model_flops(cfg, job),
        stores=[dict(s, commit_s=(commit_t - s["call_t"]
                                  if commit_t else None),
                     report=reports[0][1] if reports else None)
                for s in stores],
        recover_s=recover_s, spans=events, device_trace=reduced,
        card_leaf_bytes=_card_leaf_bytes(shapes))
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], trace):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    n_fail = len(stores) - len(reports)          # stores never committed
    out = {"correct": bool(ok and n_fail == 0),
           "attempted": len(step_times) + len(stores) +
           (1 if recover_s is not None else 0),
           "failed": n_fail, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else device.type,
                      "kind": (torch.cuda.get_device_name(device)
                               if on_card else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if reduced is not None:
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = reduced["window_s"]
        out["breakdown"] = devtrace.breakdown(reduced)
    out["checks"] = checks
    out["_log"] = {"bytes_written": written, "setup_losses": prog["loss"],
                   "reference_losses": ref["loss"],
                   "power": power_limit() if on_card else "cpu"}
    return out


def _card_leaf_bytes(shapes: Dict[str, tuple]) -> list:
    """Bytes of each float32 leaf of the state on the card: every
    parameter and its two Adam moments."""
    import math
    return [4 * math.prod(s) for s in shapes.values() for _ in range(3)]


def _planted(step_fn, fault: Optional[str]):
    """The step with a fault planted under it (tests only)."""
    if fault == "unchanged":
        from repro_torch.core.protect import flatten_named, unflatten_named

        def unchanged(state, batch):
            copy = unflatten_named({k: v.clone() for k, v in
                                    flatten_named(state).items()}, state)
            _, met = step_fn(copy, batch)
            return state._replace(step=state.step + 1), met
        return unchanged
    if fault == "half_batch":
        def half(state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step_fn(state, {k: v[:n] for k, v in batch.items()})
        return half
    return step_fn


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse
    t0 = t0 if t0 is not None else time.time()
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    workdir = spec.ROOT / "build" / "perfbench" / cell["name"]
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        out = run_cell(bench, cell, args.seed, args.seconds,
                       bool(args.trace), device, t0, workdir=workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package are loaded: {bad}")
        return 3
    extra = out.pop("_log")
    log(f"bytes written {extra['bytes_written']}; card {extra['power']}")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
