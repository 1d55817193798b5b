"""Kill/restart supervision with a live MTBF feed.

Extracted from ``launch/train.py``'s inline ``supervise()`` loop so the
policy is unit-testable (injectable clock/wall/sleep/popen) and so the two
blind spots the inline loop shipped with are fixed here once:

* **startup grace** — the old loop only consulted the heartbeat monitor
  once ``hb.last()`` was non-None, so a worker that wedged *before its
  first beat* was never killed.  A beat-less worker now dies at
  ``startup_grace_s`` (default 2x the heartbeat timeout).
* **backoff reset** — the old loop called ``backoff.failed()`` on every
  death and never reset, so one early crash taxed every later restart.
  The backoff now forgets its failure count once the current worker has
  stayed healthy (fresh beats) past ``healthy_reset_s``.

Liveness is judged against *this attempt's* beats only: a heartbeat file
left behind by the previous (dead) worker carries a wall timestamp older
than the current spawn, so it can neither mask a wedged restart nor trip
the staleness kill early.

Every worker death and heartbeat-gap kill feeds a **real** failure
observation into an :class:`~repro_torch.chaos.cadence.MTBFEstimator` (one
timebase — the supervisor's monotonic clock at observation time), and the
estimator plus the MTTR record persist to ``mtbf_feed_path``
(:class:`~repro_torch.chaos.cadence.MTBFFeed`) so a restarted worker's cadence
controller starts from observed failure reality instead of its prior.

Chaos rearm: instead of the old blanket ``env.pop("OPENCHK_CHAOS")``, the
restart env is rewritten by :func:`repro_torch.chaos.inject.restart_env` —
``rearm=True`` specs stay armed with their durable counters
(``OPENCHK_CHAOS_STATE``), so an exhausted kill spec does not re-kill the
restarted child at the same hit count, while ``rearm=False`` specs drop.
"""
from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.chaos import inject
from repro_torch.chaos.cadence import MTBFEstimator, MTBFFeed
from repro_torch.ft.backoff import ExponentialBackoff
from repro_torch.ft.detector import Heartbeat
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.health import HealthServer, HealthState


@dataclass
class SupervisorConfig:
    heartbeat_path: str
    heartbeat_timeout_s: float = 120.0
    startup_grace_s: Optional[float] = None  # None -> 2x heartbeat timeout
    healthy_reset_s: Optional[float] = None  # None -> heartbeat timeout
    max_restarts: int = 3
    backoff_base_s: float = 1.0
    backoff_max_s: float = 30.0
    poll_s: float = 1.0
    mtbf_feed_path: Optional[str] = None
    prior_mtbf_s: float = 3600.0
    #: serve /healthz, /readyz, /metrics for this supervisor (0 →
    #: ephemeral port, None → no endpoint).  Readiness = the *current*
    #: worker has beaten (flips False across a death/restart window).
    health_port: Optional[int] = None

    def startup_grace(self) -> float:
        return (self.startup_grace_s if self.startup_grace_s is not None
                else 2.0 * self.heartbeat_timeout_s)

    def healthy_reset(self) -> float:
        return (self.healthy_reset_s if self.healthy_reset_s is not None
                else self.heartbeat_timeout_s)


class Supervisor:
    """Run a worker command until success, restarting on death.

    ``clock`` (monotonic), ``wall`` (heartbeat timebase), ``sleep`` and
    ``popen`` are injectable so the whole kill/backoff/MTTR policy runs
    under a simulated clock in unit tests.
    """

    def __init__(
        self,
        cmd: Sequence[str],
        env: Dict[str, str],
        cfg: SupervisorConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        popen=subprocess.Popen,
        log: Callable[[str], None] = print,
    ) -> None:
        self.cmd = list(cmd)
        self.env = dict(env)
        self.cfg = cfg
        self.clock = clock
        self.wall = wall
        self.sleep = sleep
        self.popen = popen
        self.log = log
        self.hb = Heartbeat(cfg.heartbeat_path)
        self.backoff = ExponentialBackoff(base_s=cfg.backoff_base_s,
                                          max_s=cfg.backoff_max_s)
        # gap_failure_s stays None here: hangs are detected (and killed)
        # by the watch loop itself, which notes the failure exactly once —
        # a gap threshold on top would double-count every hang
        self.estimator = MTBFEstimator(prior_mtbf_s=cfg.prior_mtbf_s)
        self.feed = (MTBFFeed(cfg.mtbf_feed_path)
                     if cfg.mtbf_feed_path else None)
        self.attempts = 0
        self.deaths = 0
        self.gap_kills = 0
        self.mttr_s: List[float] = []
        self.health = HealthState(name="supervisor")
        self.health_server: Optional[HealthServer] = None
        if cfg.health_port is not None:
            self.health_server = HealthServer(
                self.health, port=cfg.health_port).start()
            self.log(f"[supervisor] health endpoint on "
                     f"{self.health_server.url}")

    # -- the restart loop --------------------------------------------------
    def run(self) -> int:
        try:
            return self._run()
        finally:
            if self.health_server is not None:
                self.health_server.stop()
                self.health_server = None
            self._merge_trace()

    def _run(self) -> int:
        death_t: Optional[float] = None
        while self.attempts < self.cfg.max_restarts + 1:
            self.attempts += 1
            self.log(f"[supervisor] attempt {self.attempts}")
            if self.attempts > 1:
                ttrace.instant("supervisor.restart", attempt=self.attempts)
                tmetrics.counter("openchk_worker_restarts_total").inc()
            spawn_wall = self.wall()
            spawn_t = self.clock()
            with ttrace.span("supervisor.attempt", attempt=self.attempts):
                p = self.popen(self.cmd, env=self.env)
                rc, why = self._watch(p, spawn_wall, spawn_t, death_t)
            if rc == 0:
                self.log(f"[supervisor] success after {self.attempts} "
                         f"attempt(s); deaths={self.deaths} "
                         f"mtbf_estimate={self.estimator.estimate():.1f}s")
                self._write_feed()
                return 0
            death_t = self.clock()
            self.deaths += 1
            self.estimator.note_failure(death_t)
            self.health.set_ready(False, reason=f"worker died ({why})",
                                  attempt=self.attempts)
            ttrace.instant("worker.death", rc=rc, why=why,
                           last_step=self.hb.last_step(),
                           attempt=self.attempts)
            tmetrics.counter("openchk_worker_deaths_total").inc()
            self.log(f"[supervisor] worker died rc={rc} via {why} "
                     f"(last step {self.hb.last_step()}); restarting "
                     f"from checkpoint")
            # spec-declared rearm semantics instead of the old blanket
            # env.pop: exhausted kill specs stay exhausted via the durable
            # state file; rearm=False specs drop for the next child
            self.env = inject.restart_env(self.env)
            self._write_feed()
            delay = self.backoff.failed()
            if delay > 0:
                self.log(f"[supervisor] backing off {delay:.1f}s "
                         f"before restart")
                self.sleep(delay)
        self.log("[supervisor] giving up")
        self._write_feed()
        return 1

    def _merge_trace(self) -> None:
        """Dir-mode runs end with one perfetto-loadable ``trace.json``:
        flush this process's events, then fold in every per-process file
        the (possibly killed and restarted) workers left behind."""
        d = ttrace.tracer().trace_dir()
        if d is not None:
            ttrace.flush()
            merged = ttrace.merge_dir(d)
            if merged:
                self.log(f"[supervisor] merged trace → {merged}")

    def _watch(self, p, spawn_wall: float, spawn_t: float,
               death_t: Optional[float]):
        """Poll one worker until it exits or is declared dead.

        Returns ``(rc, why)`` with ``why`` one of ``exit`` /
        ``startup-grace`` / ``heartbeat-gap``."""
        grace = self.cfg.startup_grace()
        reset_after = self.cfg.healthy_reset()
        recovered = death_t is None  # nothing to recover from on attempt 1
        last_beat_wall: Optional[float] = None
        while True:
            rc = p.poll()
            if rc is not None:
                return rc, "exit"
            self.sleep(self.cfg.poll_s)
            now = self.clock()
            bw = self.hb.last()
            fresh = bw is not None and bw >= spawn_wall
            if not fresh:
                # no beat from THIS worker yet (a leftover file from the
                # dead predecessor is not liveness): the pre-first-beat
                # wedge dies at the grace deadline
                if now - spawn_t >= grace:
                    self.gap_kills += 1
                    self.log(f"[supervisor] no heartbeat within startup "
                             f"grace ({grace:.1f}s) → killing worker")
                    return self._kill(p), "startup-grace"
                continue
            if last_beat_wall is None:
                # first beat from THIS worker: it is making progress
                self.health.set_ready(True, step=self.hb.last_step(),
                                      attempt=self.attempts)
            if not recovered:
                recovered = True
                mttr = now - death_t
                self.mttr_s.append(mttr)
                tmetrics.histogram("openchk_mttr_seconds").observe(mttr)
                ttrace.instant("supervisor.recovered", mttr_s=round(mttr, 3),
                               attempt=self.attempts)
                self.log(f"[supervisor] recovery complete: "
                         f"mttr {mttr:.2f}s")
            if bw != last_beat_wall:
                last_beat_wall = bw
                self.estimator.note_progress(now)
            if self.wall() - bw >= self.cfg.heartbeat_timeout_s:
                self.gap_kills += 1
                self.log("[supervisor] heartbeat timeout → killing worker")
                return self._kill(p), "heartbeat-gap"
            self.backoff.note_healthy_span(now - spawn_t, reset_after)

    @staticmethod
    def _kill(p) -> int:
        p.kill()
        return p.wait()

    def _write_feed(self) -> None:
        tmetrics.gauge("openchk_mtbf_estimate_seconds").set(
            self.estimator.estimate())
        if self.feed is not None:
            self.feed.write(self.estimator, deaths=self.deaths,
                            mttr_s=self.mttr_s)
