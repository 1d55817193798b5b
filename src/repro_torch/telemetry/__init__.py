"""Telemetry plane: span tracing and the metrics registry (stdlib-only
leaves every layer can import without cycles).

- :mod:`repro_torch.telemetry.trace` — thread-safe span/instant recorder
  with a no-op fast path when disabled, exporting Chrome trace-event JSON.
- :mod:`repro_torch.telemetry.metrics` — counter/gauge/histogram registry
  fed by the same instrumentation points.
- :mod:`repro_torch.telemetry.health` — ``/healthz`` / ``/readyz`` /
  ``/metrics`` over stdlib HTTP, for the supervisor.
"""
from repro_torch.telemetry import health, metrics, trace

__all__ = ["trace", "metrics", "health"]
