"""Live health endpoints: ``/healthz``, ``/readyz``, ``/metrics``.

A :class:`HealthServer` is a real stdlib HTTP server (ThreadingHTTPServer
on a daemon thread, loopback only, ephemeral port by default) fronting a
thread-safe :class:`HealthState`:

- ``/healthz`` — 200 while the process is up; liveness never flips.
- ``/readyz``  — 200/503 from ``HealthState.ready`` plus its info dict
  (epoch, entry id, reason).  For a serving replica readiness follows the
  ``WeightsHandle`` swap protocol: :func:`attach_engine` chains onto
  ``ServingEngine.swap_hook`` so every atomic weight flip re-asserts
  readiness with the new epoch — and a deployer can drop readiness for the
  pull window so a rolling swap is observable from outside the process.
- ``/metrics`` — Prometheus text from the process-wide registry.

One server per serving replica and one per supervisor; everything is
stdlib so the endpoint works in the most degraded environments (which is
when you need it).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from repro_torch.telemetry import metrics


class HealthState:
    """Thread-safe readiness flag + info payload for ``/readyz``."""

    def __init__(self, name: str = "", ready: bool = False) -> None:
        self._lock = threading.Lock()
        self.name = name
        self._ready = ready
        self._info: Dict[str, Any] = {}

    def set_ready(self, ready: bool, **info: Any) -> None:
        with self._lock:
            self._ready = bool(ready)
            self._info.update(info)
        if self.name:
            metrics.gauge("openchk_serve_ready",
                          replica=self.name).set(1.0 if ready else 0.0)

    @property
    def ready(self) -> bool:
        with self._lock:
            return self._ready

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            d = dict(self._info)
        d["ready"] = self.ready
        if self.name:
            d["name"] = self.name
        return d


class _Handler(BaseHTTPRequestHandler):
    # set per-server via type(); BaseHTTPRequestHandler has no ctor hook
    state: HealthState

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._send(200, b'{"status": "ok"}\n', "application/json")
        elif path == "/readyz":
            d = self.state.describe()
            body = (json.dumps(d) + "\n").encode()
            self._send(200 if d["ready"] else 503, body,
                       "application/json")
        elif path == "/metrics":
            self._send(200, metrics.to_prometheus().encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send(404, b'{"error": "not found"}\n', "application/json")

    def log_message(self, fmt: str, *args: Any) -> None:
        return  # health probes must not spam stderr


class HealthServer:
    """HTTP endpoint for one HealthState.  ``port=0`` → ephemeral."""

    def __init__(self, state: HealthState, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.state = state
        handler = type("BoundHandler", (_Handler,), {"state": state})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HealthServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"health:{self.state.name or self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"


def attach_engine(engine: Any, name: str = "serve",
                  port: Optional[int] = None) -> HealthState:
    """Bind a HealthState to a ServingEngine's swap protocol.

    Readiness starts True (the engine is constructed with weights) and is
    re-asserted — with the fresh epoch/entry id — on every ``set_weights``
    by chaining onto ``swap_hook``.  The deployer flips it False for the
    pull window; the swap hook flips it back.  With *port*, also starts a
    HealthServer and stores it at ``state.server``."""
    state = HealthState(name=name, ready=True)
    handle = engine.weights
    state.set_ready(True, epoch=int(handle.epoch),
                    entry_id=handle.entry_id)

    prev_hook = engine.swap_hook

    def _hook(old: Any, new: Any) -> None:
        state.set_ready(True, epoch=int(new.epoch), entry_id=new.entry_id,
                        reason="swapped")
        if prev_hook is not None:
            prev_hook(old, new)

    engine.swap_hook = _hook
    if port is not None:
        state.server = HealthServer(state, port=port).start()  # type: ignore[attr-defined]
    return state
