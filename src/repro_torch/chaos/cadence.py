"""Daly-optimal adaptive checkpoint cadence.

Implements the higher-order optimum-interval estimate from Daly, "A higher
order estimate of the optimum checkpoint interval for restart dumps"
(FGCS 2006), and the progress-rate / checkpoint-efficiency model from
Daly & Jones, "Quantifying checkpoint efficiency" — the equations that
SNIPPETS.md snippet 3 (comd-ft ``progress_rate_test.c``) encodes. The
snippet's reference constants (10 TB/s peak store/recovery bandwidth,
1-year per-node MTBF scaling linearly with node count, 2432 GB/node with a
20% checkpoint fraction) are mirrored in :data:`REFERENCE` and pinned by
unit tests.

Model (delta = checkpoint write cost, R = restart/recovery cost, M = MTBF):

* optimum interval, for delta < 2M::

      tau_opt = sqrt(2 delta M) * [1 + (1/3) sqrt(delta / 2M)
                                     + (1/9) (delta / 2M)] - delta

  and ``tau_opt = M`` once delta >= 2M (checkpointing costs more than the
  expected uptime — take the full interval).

* expected total wall time for Ts seconds of useful work, with Poisson
  failures at rate 1/M (Daly eq. 13)::

      T(tau) = M e^{R/M} (e^{(tau+delta)/M} - 1) Ts / tau

  giving  ``progress_rate(tau) = Ts / T = tau e^{-R/M} / (M (e^{(tau+delta)/M} - 1))``
  — the fraction of wall time that is forward progress.

* ``checkpoint_efficiency = progress_rate(tau_opt)`` — the best achievable
  fraction given the platform's (delta, R, M); what the bench gates.

:class:`CadenceController` feeds these from live signals: per-level store
cost EWMA from pipeline :class:`~repro_torch.core.pipeline.StoreReport` s,
recovery cost from observed restores, and MTBF estimated online from
``ft/detector`` heartbeat gaps plus the chaos registry's injected-fault
history. L1's tiny delta keeps it frequent; L4's full-bandwidth delta
tracks the Daly optimum.
"""
from __future__ import annotations

import json
import math
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# -- reference constants (SNIPPETS.md snippet 3, comd-ft) -------------------
SECONDS_PER_YEAR = 365.25 * 86400.0

# checkpoint kinds, mirrored from core/protect.py (string-stable contract;
# re-declared here so the chaos package stays a stdlib-only leaf)
CHK_FULL_KIND = "FULL"
CHK_DIFF_KIND = "DIFF"


@dataclass(frozen=True)
class ReferenceConstants:
    """comd-ft progress_rate_test.c platform model."""

    peak_bw_gb_s: float = 10000.0  # checkpoint store bandwidth
    peak_rec_bw_gb_s: float = 10000.0  # recovery read bandwidth
    mtbf_per_node_s: float = SECONDS_PER_YEAR  # 1 year per node
    mem_per_node_gb: float = 2432.0
    mem_chkpt_frac: float = 0.20

    @property
    def chkpt_gb_per_node(self) -> float:
        return self.mem_per_node_gb * self.mem_chkpt_frac  # 486.4 GB

    def platform(self, num_nodes: int) -> "Platform":
        """System-level (delta, R, M) for a machine of *num_nodes* nodes.

        Snippet assumptions: MTBF scales down linearly with node count;
        recovery reads the same bytes the checkpoint wrote.
        """
        size_gb = self.chkpt_gb_per_node * num_nodes
        return Platform(
            delta_s=size_gb / self.peak_bw_gb_s,
            recovery_s=size_gb / self.peak_rec_bw_gb_s,
            mtbf_s=self.mtbf_per_node_s / num_nodes,
        )


REFERENCE = ReferenceConstants()


@dataclass(frozen=True)
class Platform:
    delta_s: float
    recovery_s: float
    mtbf_s: float


# -- closed-form Daly equations ---------------------------------------------
def daly_interval(delta_s: float, mtbf_s: float) -> float:
    """Higher-order optimum compute interval between checkpoints (seconds)."""
    if delta_s <= 0.0:
        raise ValueError("checkpoint cost delta must be positive")
    if mtbf_s <= 0.0:
        raise ValueError("MTBF must be positive")
    if delta_s >= 2.0 * mtbf_s:
        return mtbf_s
    x = delta_s / (2.0 * mtbf_s)
    return math.sqrt(2.0 * delta_s * mtbf_s) * (
        1.0 + math.sqrt(x) / 3.0 + x / 9.0
    ) - delta_s


def progress_rate(tau_s: float, delta_s: float, recovery_s: float, mtbf_s: float) -> float:
    """Fraction of wall time spent on forward progress at interval tau."""
    if tau_s <= 0.0 or mtbf_s <= 0.0:
        raise ValueError("interval and MTBF must be positive")
    expo = (tau_s + delta_s) / mtbf_s
    if expo > 500.0:  # e^{expo} overflows; rate is numerically zero
        return 0.0
    return tau_s * math.exp(-recovery_s / mtbf_s) / (mtbf_s * (math.expm1(expo)))


def checkpoint_efficiency(delta_s: float, recovery_s: float, mtbf_s: float) -> float:
    """Best achievable progress rate: progress_rate at the Daly optimum."""
    return progress_rate(daly_interval(delta_s, mtbf_s), delta_s, recovery_s, mtbf_s)


# -- online MTBF estimation --------------------------------------------------
class MTBFEstimator:
    """MTBF = observed uptime span / failures, smoothed by a prior.

    Signals: explicit failures (injected-fault history, supervisor
    restarts) and progress marks (heartbeats / steps) that extend the
    observed span. A heartbeat gap longer than ``gap_failure_s`` counts as
    a failure signal — a silent worker is indistinguishable from a dead
    one at the cadence layer.
    """

    def __init__(
        self,
        prior_mtbf_s: float = 3600.0,
        prior_weight: float = 1.0,
        gap_failure_s: Optional[float] = None,
    ) -> None:
        self.prior_mtbf_s = float(prior_mtbf_s)
        self.prior_weight = float(prior_weight)
        self.gap_failure_s = gap_failure_s
        self._span_s = 0.0
        self._failures = 0
        self._last_t: Optional[float] = None

    @property
    def failures(self) -> int:
        return self._failures

    @property
    def span_s(self) -> float:
        return self._span_s

    def merge(self, failures: int, span_s: float) -> None:
        """Fold in observations made by *another* estimator — the
        supervisor's real worker-death/heartbeat-gap record, handed to a
        restarted worker through :class:`MTBFFeed` — without disturbing
        this estimator's own progress cursor."""
        if span_s > 0.0:
            self._span_s += float(span_s)
        if failures > 0:
            self._failures += int(failures)

    def note_progress(self, t: Optional[float] = None) -> None:
        """A liveness mark (heartbeat / step) at monotonic time *t*."""
        t = time.monotonic() if t is None else t
        if self._last_t is not None:
            gap = t - self._last_t
            if gap > 0.0:
                self._span_s += gap
                if self.gap_failure_s is not None and gap > self.gap_failure_s:
                    self._failures += 1
        self._last_t = t

    def note_failure(self, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        if self._last_t is not None and t > self._last_t:
            self._span_s += t - self._last_t
        self._last_t = t
        self._failures += 1

    def ingest_fault_times(self, times: List[float]) -> None:
        """Feed the chaos registry's fired-fault monotonic timestamps."""
        for t in sorted(times):
            self.note_failure(t)

    def estimate(self) -> float:
        """Posterior-mean MTBF (prior acts as one pseudo-observation)."""
        num = self.prior_mtbf_s * self.prior_weight + self._span_s
        den = self.prior_weight + self._failures
        return num / den if den > 0 else self.prior_mtbf_s


class MTBFFeed:
    """Durable failure-observation file: supervisor writes, worker seeds.

    The supervisor watches worker deaths and heartbeat gaps from outside
    the process; a restarted worker's fresh :class:`MTBFEstimator` would
    otherwise start blind at the prior.  The feed closes that loop: the
    supervisor :meth:`write` s its estimator's (failures, span) plus
    death/MTTR bookkeeping after every death, and the worker
    :meth:`seed` s them into its cadence estimator at startup.  Atomic
    tmp+replace writes; malformed content warns and seeds nothing — a
    corrupt feed must never stop a restart."""

    def __init__(self, path: str) -> None:
        self.path = path

    def read(self) -> Optional[Dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                blob = json.load(f)
            if not isinstance(blob, dict):
                raise ValueError("feed root must be a JSON object")
            return blob
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            warnings.warn(f"ignoring malformed MTBF feed at {self.path}: {e}",
                          RuntimeWarning, stacklevel=2)
            return None

    def write(self, estimator: MTBFEstimator, *, deaths: int = 0,
              mttr_s: Optional[List[float]] = None) -> None:
        blob = {
            "failures": estimator.failures,
            "span_s": round(estimator.span_s, 6),
            "estimate_s": round(estimator.estimate(), 6),
            "deaths": deaths,
            "mttr_s": [round(m, 6) for m in (mttr_s or [])],
        }
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(blob, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError as e:
            warnings.warn(f"could not write MTBF feed to {self.path}: {e}",
                          RuntimeWarning, stacklevel=2)

    def seed(self, estimator: MTBFEstimator) -> bool:
        """Merge the feed's observations into *estimator*; True if any."""
        blob = self.read()
        if not blob:
            return False
        try:
            failures = int(blob.get("failures", 0))
            span_s = float(blob.get("span_s", 0.0))
        except (TypeError, ValueError) as e:
            warnings.warn(f"ignoring malformed MTBF feed at {self.path}: {e}",
                          RuntimeWarning, stacklevel=2)
            return False
        if failures <= 0 and span_s <= 0.0:
            return False
        estimator.merge(failures, span_s)
        return True


# -- per-tier cadence controller ---------------------------------------------
@dataclass
class _LevelCost:
    store_s: Optional[float] = None  # EWMA (FULL / promoted stores)
    diff_store_s: Optional[float] = None  # EWMA (non-promoted DIFF stores)
    dirty_ratio: Optional[float] = None  # EWMA of observed DIFF dirty ratio
    recovery_s: Optional[float] = None  # EWMA
    n_stores: int = 0


@dataclass
class CadenceConfig:
    levels: tuple = (1, 2, 3, 4)
    ewma: float = 0.3  # weight of the newest observation
    min_interval_s: float = 1e-3
    max_interval_s: float = 7 * 86400.0
    prior_mtbf_s: float = 3600.0
    prior_store_s: float = 1.0  # assumed delta before any measurement
    gap_failure_s: Optional[float] = None
    #: dirty-ratio break-even above which the diff engine promotes to
    #: FULL (mirrors StorageConfig.promote_threshold) — at or past it the
    #: DIFF interval collapses onto the FULL interval, because the store
    #: the schedule would trigger is going to be a FULL anyway
    promote_threshold: float = 0.95


class CadenceController:
    """Per-tier Daly-optimal checkpoint intervals from live measurements.

    Wire-up: ``pipeline.on_report = controller.note_report`` feeds store
    costs; the training loop calls :meth:`note_step` each step (extends the
    MTBF uptime span) and asks :meth:`due_levels` which checkpoint levels
    are due now. Restores feed :meth:`note_recovery`; failures (supervisor
    restarts, chaos history) feed :meth:`note_failure` /
    :meth:`ingest_chaos_history`.
    """

    def __init__(self, config: Optional[CadenceConfig] = None) -> None:
        self.cfg = config or CadenceConfig()
        self.mtbf = MTBFEstimator(
            prior_mtbf_s=self.cfg.prior_mtbf_s,
            gap_failure_s=self.cfg.gap_failure_s,
        )
        self._costs: Dict[int, _LevelCost] = {lv: _LevelCost() for lv in self.cfg.levels}
        self._last_store_t: Dict[int, float] = {}
        self._ingested_faults = 0

    # -- observations -----------------------------------------------------
    def _ewma(self, old: Optional[float], new: float) -> float:
        if old is None:
            return new
        a = self.cfg.ewma
        return a * new + (1.0 - a) * old

    def note_store(self, level: int, seconds: float) -> None:
        c = self._costs.setdefault(level, _LevelCost())
        c.store_s = self._ewma(c.store_s, float(seconds))
        c.n_stores += 1

    def note_diff_store(self, level: int, seconds: Optional[float] = None,
                        dirty_ratio: Optional[float] = None) -> None:
        """A non-promoted DIFF store: its own cost EWMA + dirty ratio."""
        c = self._costs.setdefault(level, _LevelCost())
        if seconds is not None:
            c.diff_store_s = self._ewma(c.diff_store_s, float(seconds))
            c.n_stores += 1
        if dirty_ratio is not None:
            c.dirty_ratio = self._ewma(c.dirty_ratio, float(dirty_ratio))

    def note_report(self, report) -> None:
        """Observer hook for ``CheckpointPipeline.on_report``.

        Routes by what the store actually was: a DIFF that the engine
        promoted to FULL (dirty ratio past break-even) is a FULL cost
        observation — charging its wall time to the DIFF EWMA would make
        the DIFF schedule pay FULL prices forever after one hot step."""
        level = int(report.level)
        kind = getattr(report, "kind", CHK_FULL_KIND)
        promoted = bool(getattr(report, "promoted_full", False))
        dirty = getattr(report, "dirty_ratio", None)
        if kind == CHK_DIFF_KIND and not promoted:
            self.note_diff_store(level, float(report.seconds), dirty)
        else:
            self.note_store(level, float(report.seconds))
            if promoted and dirty is not None:
                # the promotion still carries dirty-ratio evidence
                self.note_diff_store(level, None, float(dirty))

    def note_recovery(self, level: int, seconds: float) -> None:
        c = self._costs.setdefault(level, _LevelCost())
        c.recovery_s = self._ewma(c.recovery_s, float(seconds))

    def note_step(self, t: Optional[float] = None) -> None:
        self.mtbf.note_progress(t)

    def note_failure(self, t: Optional[float] = None) -> None:
        self.mtbf.note_failure(t)

    def ingest_chaos_history(self, registry=None) -> int:
        """Fold newly-fired injected faults into the MTBF estimate."""
        if registry is None:
            from repro_torch.chaos.inject import registry as _reg

            registry = _reg()
        times = registry.fault_times()
        fresh = times[self._ingested_faults:]
        self.mtbf.ingest_fault_times(fresh)
        self._ingested_faults = len(times)
        return len(fresh)

    # -- model outputs ----------------------------------------------------
    def store_cost(self, level: int) -> float:
        c = self._costs.get(level)
        if c is None or c.store_s is None:
            return self.cfg.prior_store_s
        return c.store_s

    def recovery_cost(self, level: int) -> float:
        c = self._costs.get(level)
        if c is not None and c.recovery_s is not None:
            return c.recovery_s
        # snippet assumption (2): recovery reads what the store wrote
        return self.store_cost(level)

    def diff_store_cost(self, level: int) -> float:
        """Expected delta for a DIFF store at *level* — the dirty-ratio
        economics folded into the Daly math.

        Past the promote threshold the engine turns the DIFF into a FULL,
        so the cost *is* the FULL cost.  Below it, a measured DIFF EWMA
        wins; with only a dirty ratio observed, the FULL cost scales by
        it (a DIFF writes ~dirty_ratio of the payload); with nothing
        observed, assume FULL (never schedule cheaper than evidence)."""
        c = self._costs.get(level)
        full = self.store_cost(level)
        if c is None:
            return full
        if (c.dirty_ratio is not None
                and c.dirty_ratio >= self.cfg.promote_threshold):
            return full
        if c.diff_store_s is not None:
            return c.diff_store_s
        if c.dirty_ratio is not None:
            return max(c.dirty_ratio, 1e-3) * full
        return full

    def interval_for(self, level: int, kind: str = CHK_FULL_KIND) -> float:
        """Daly-optimal compute interval for *level*, clamped to config.

        ``kind=CHK_DIFF_KIND`` paces DIFF stores by their own (cheaper)
        delta instead of FULL pricing — the ROADMAP's cadence-aware DIFF
        scheduling rung."""
        delta = (self.diff_store_cost(level) if kind == CHK_DIFF_KIND
                 else self.store_cost(level))
        tau = daly_interval(delta, self.mtbf.estimate())
        return min(max(tau, self.cfg.min_interval_s), self.cfg.max_interval_s)

    def schedule(self, kind: str = CHK_FULL_KIND) -> Dict[int, float]:
        return {lv: self.interval_for(lv, kind) for lv in self.cfg.levels}

    def due_levels(self, now: Optional[float] = None,
                   kind: str = CHK_FULL_KIND) -> List[int]:
        """Levels whose interval has elapsed since their last store.

        Highest level first, so a step that crosses several thresholds
        stores once at the strongest tier (tier stacks nest: L4's stack
        includes the local tier).
        """
        now = time.monotonic() if now is None else now
        due = []
        for lv in sorted(self.cfg.levels, reverse=True):
            last = self._last_store_t.get(lv)
            if last is None or (now - last) >= self.interval_for(lv, kind):
                due.append(lv)
        return due

    def mark_stored(self, level: int, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        # a store at level L refreshes every nested weaker level too
        for lv in self.cfg.levels:
            if lv <= level:
                self._last_store_t[lv] = now

    def progress_rate(self, level: int = 4) -> float:
        return progress_rate(
            self.interval_for(level),
            self.store_cost(level),
            self.recovery_cost(level),
            self.mtbf.estimate(),
        )

    def checkpoint_efficiency(self, level: int = 4) -> float:
        return checkpoint_efficiency(
            self.store_cost(level),
            self.recovery_cost(level),
            self.mtbf.estimate(),
        )

    def datapoints(self, level: int = 4) -> Dict[str, float]:
        """First-class bench datapoints (bench_overhead.py surfaces these)."""
        return {
            "cadence_interval_s": self.interval_for(level),
            "cadence_store_cost_s": self.store_cost(level),
            "cadence_mtbf_s": self.mtbf.estimate(),
            "progress_rate": self.progress_rate(level),
            "checkpoint_efficiency": self.checkpoint_efficiency(level),
        }
