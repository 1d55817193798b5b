"""Training loop with OpenCHK integration — the core of the launcher.

The PyTorch counterpart of ``repro.train.loop``.  The whole CR surface in
the loop is exactly the paper's five lines:

    ctx = CheckpointContext(cfg, comm)                 # chk init
    state = ctx.load(state)                            # chk load
    ...
    ctx.store(state, id=step, level=lv, if_=cond)      # chk store
    ctx.shutdown()                                     # chk shutdown

Level cycling follows FTI practice: frequent cheap L1, periodic L2/L3,
rare L4 (PFS). Heartbeats feed the launcher's failure detector.  Batches
go to the device of the parameters.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.chaos import inject as chaos
from repro_torch.chaos.cadence import CadenceController
from repro_torch.core.context import CHK_FULL, CheckpointContext
from repro_torch.data.synthetic import next_batch
from repro_torch.ft.detector import Heartbeat
from repro_torch.ft.failures import FaultInjector, SimulatedFault
from repro_torch.models.zoo import Model
from repro_torch.telemetry import trace as ttrace
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.state import TrainState


@dataclass
class LevelSchedule:
    """FTI-style level cycle: which level for the k-th checkpoint."""
    l1_every: int = 1
    l2_every: int = 2
    l3_every: int = 4
    l4_every: int = 8

    def level_for(self, ckpt_index: int) -> int:
        if self.l4_every and ckpt_index % self.l4_every == 0:
            return 4
        if self.l3_every and ckpt_index % self.l3_every == 0:
            return 3
        if self.l2_every and ckpt_index % self.l2_every == 0:
            return 2
        return 1


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 10
    kind: str = CHK_FULL            # CHK_DIFF → differential checkpoints
    levels: LevelSchedule = field(default_factory=LevelSchedule)
    heartbeat_path: Optional[str] = None
    log_every: int = 10
    #: Daly-optimal adaptive cadence (chaos/cadence.py).  When set, the
    #: fixed ckpt_every/LevelSchedule cycle is replaced by wall-time
    #: intervals the controller derives per tier from measured store cost
    #: and its online MTBF estimate.
    cadence: Optional[CadenceController] = None
    #: treat a silent gap longer than this between observed steps as a
    #: failure in the cadence controller's MTBF estimator (wired from the
    #: launcher's --heartbeat-timeout)
    gap_failure_s: Optional[float] = None


def run_training(
    model: Model,
    train_step: Callable,
    state: TrainState,
    ckpt: CheckpointContext,
    loop: LoopConfig,
    global_batch: int,
    seq_len: int,
    injector: Optional[FaultInjector] = None,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Run (or resume) training to total_steps. Returns summary metrics."""
    hb = Heartbeat(loop.heartbeat_path) if loop.heartbeat_path else None

    cadence = loop.cadence
    if cadence is not None:
        ckpt.observe_store_reports(cadence.note_report)  # store-cost feed
        if loop.gap_failure_s is not None and \
                cadence.mtbf.gap_failure_s is None:
            cadence.mtbf.gap_failure_s = loop.gap_failure_s

    # ---- chk load: transparent restart ---------------------------------- #
    t_load = time.time()
    with ttrace.span("train.load"):
        state = ckpt.load(state)
    start = int(state.step)
    if ckpt.restarted:
        ttrace.instant("train.resume", step=start)
        log(f"[openchk] restart detected → resuming from step {start}")
        if cadence is not None:
            cadence.note_failure()
            cadence.note_recovery(4, time.time() - t_load)

    t0 = time.time()
    metrics: Dict[str, Any] = {}
    n_ckpts = 0
    device = tree_leaves(state.params)[0].device

    for step in range(start, loop.total_steps):
        batch, next_ds = next_batch(state.data_state, model.cfg,
                                    global_batch, seq_len, device)
        state, metrics = train_step(state, batch)
        state = state._replace(data_state=next_ds)   # exactly-once cursor

        if injector is not None:
            injector.maybe_fail(step + 1)
        chaos.fire(chaos.SITES.TRAIN_STEP, exc=SimulatedFault, step=step + 1)

        # ---- chk store with if_/id/level/kind clauses ------------------- #
        if cadence is not None:
            cadence.note_step()
            cadence.ingest_chaos_history()
            due = cadence.due_levels(kind=loop.kind)
            is_ckpt = bool(due)
            if is_ckpt:
                n_ckpts += 1
                level = due[0]           # strongest due tier (stacks nest)
                cadence.mark_stored(level)
            else:
                level = 1
        else:
            is_ckpt = (step + 1) % loop.ckpt_every == 0
            if is_ckpt:
                n_ckpts += 1
            level = loop.levels.level_for(n_ckpts)
        ckpt.store(
            state,
            id=step + 1,
            level=level,
            kind=loop.kind,
            if_=is_ckpt,
        )

        if hb is not None:
            hb.beat(step + 1)
        if (step + 1) % loop.log_every == 0:
            log(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                f"({(time.time() - t0):.1f}s)")

    ckpt.wait()
    summary = {
        "final_step": loop.total_steps,
        "loss": float(metrics.get("loss", float("nan"))),
        "seconds": time.time() - t0,
        "restarted": ckpt.restarted,
        "stats": dict(ckpt.stats),
        "state": state,
    }
    if cadence is not None:
        summary["cadence"] = cadence.datapoints()
    return summary
