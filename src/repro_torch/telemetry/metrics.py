"""Counter/gauge/histogram registry with JSON snapshot + Prometheus text.

One process-wide :class:`MetricsRegistry` (module singleton, mirroring the
tracer) fed by the same instrumentation points as the spans: the pipeline's
commit, the chunk uploader's stats sites, deploy swaps, supervisor
deaths/restarts, chaos fault fires and the cadence controller.  Unlike the
tracer there is no enable switch — a metric update is a dict lookup plus an
integer add under a lock, cheap enough to be always on, and the registry is
what ``/metrics`` (health.py) and the chaos runner's embedded snapshots
read.

Metric naming follows Prometheus convention: ``openchk_`` prefix,
``_total`` suffix on counters, ``_seconds``/``_bytes`` units in the name,
labels for low-cardinality dimensions (level, kind, site, replica).

The canonical instrument set (all created lazily on first touch):

========================================  =========  =======================
name                                      kind       labels
========================================  =========  =======================
openchk_store_total                       counter    level, kind
openchk_store_bytes_total                 counter    level, kind
openchk_store_seconds                     histogram  level
openchk_chunks_uploaded_total             counter    —
openchk_chunks_deduped_total              counter    —
openchk_chunk_bytes_uploaded_total        counter    —
openchk_chunk_bytes_deduped_total         counter    —
openchk_deploy_swaps_total                counter    replica
openchk_deploy_pulls_failed_total         counter    replica
openchk_deploy_bytes_fetched_total        counter    —
openchk_fleet_entry_id                    gauge      replica
openchk_serve_ready                      gauge      replica
openchk_serve_epoch                       gauge      replica
openchk_faults_fired_total                counter    site, mode
openchk_worker_deaths_total               counter    —
openchk_worker_restarts_total             counter    —
openchk_mttr_seconds                      histogram  —
openchk_mtbf_estimate_seconds             gauge      —
openchk_cadence_interval_seconds          gauge      level
openchk_d2h_bytes_total                   counter    memory
openchk_h2d_bytes_total                   counter    memory
openchk_restore_read_bytes_total          counter    tier
========================================  =========  =======================

The copy counters count the bytes of every tensor the store's snapshot
copies to the host (``d2h``: ``core/protect.to_host``) and of every host
array a restore places on a template leaf's device (``h2d``:
``core/tcl.TCL.load``); ``memory`` names the host side's memory,
``pageable`` or ``pinned``.  ``openchk_restore_read_bytes_total`` counts
the container bytes a restore read, by the tier that gave them.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

# Default histogram buckets: seconds-flavored, wide enough for both a
# sub-ms L1 store and a multi-minute MTTR.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0, 300.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey, extra: Optional[Dict[str, str]] = None) -> str:
    items = list(key)
    if extra:
        items = items + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


class Counter:
    """Monotonic float counter."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """→ [(le, cumulative_count), ...] ending with (+Inf, count)."""
        with self._lock:
            out, acc = [], 0
            for le, c in zip(self.buckets, self.counts):
                acc += c
                out.append((le, acc))
            out.append((float("inf"), self.count))
            return out


class MetricsRegistry:
    """Get-or-create instrument store keyed by (name, sorted labels)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> ("counter"|"gauge"|"histogram", {label_key: instrument})
        self._families: Dict[str, Tuple[str, Dict[LabelKey, Any]]] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any],
             factory) -> Any:
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, {})
                self._families[name] = fam
            if fam[0] != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {fam[0]}")
            inst = fam[1].get(key)
            if inst is None:
                inst = factory()
                fam[1][key] = inst
            return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels: Any) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets))

    def reset(self) -> None:
        with self._lock:
            self._families = {}

    # -- exposition ------------------------------------------------------- #

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly dump: name → {kind, series: [{labels, ...}]}."""
        with self._lock:
            families = {n: (k, dict(s)) for n, (k, s) in
                        self._families.items()}
        out: Dict[str, Any] = {}
        for name, (kind, series) in sorted(families.items()):
            rows = []
            for key, inst in sorted(series.items()):
                row: Dict[str, Any] = {"labels": dict(key)}
                if kind == "histogram":
                    row.update(sum=inst.sum, count=inst.count,
                               buckets=[[le if le != float("inf") else
                                         "+Inf", c]
                                        for le, c in inst.cumulative()])
                else:
                    row["value"] = inst.value
                rows.append(row)
            out[name] = {"kind": kind, "series": rows}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            families = {n: (k, dict(s)) for n, (k, s) in
                        self._families.items()}
        lines: List[str] = []
        for name, (kind, series) in sorted(families.items()):
            lines.append(f"# TYPE {name} {kind}")
            for key, inst in sorted(series.items()):
                if kind == "histogram":
                    for le, c in inst.cumulative():
                        le_s = "+Inf" if le == float("inf") else repr(le)
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(key, {'le': le_s})} {c}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} {inst.sum}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {inst.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(key)} {inst.value}")
        return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str, **labels: Any) -> Counter:
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: Any) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
              **labels: Any) -> Histogram:
    return _REGISTRY.histogram(name, buckets=buckets, **labels)


def snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()


def to_prometheus() -> str:
    return _REGISTRY.to_prometheus()


def reset() -> None:
    _REGISTRY.reset()


def note_store_report(report: Any) -> None:
    """Feed a pipeline ``StoreReport`` into the canonical store metrics.

    Called directly from ``CheckpointPipeline.commit`` (the single-slot
    ``on_report`` hook stays free for user observers like the cadence
    controller)."""
    level = str(getattr(report, "level", "?"))
    kind = str(getattr(report, "kind", "?"))
    counter("openchk_store_total", level=level, kind=kind).inc()
    counter("openchk_store_bytes_total", level=level, kind=kind).inc(
        float(getattr(report, "bytes_payload", 0) or 0))
    histogram("openchk_store_seconds", level=level).observe(
        float(getattr(report, "seconds", 0.0) or 0.0))
