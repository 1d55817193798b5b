"""Thread-safe span tracer exporting Chrome trace-event JSON.

The whole stack shares one process-wide :class:`Tracer` (the module-level
singleton, like the chaos registry): the training thread's Plan, the CP
thread's Pack/Place/Commit, transfer-pool chunk uploads, the supervisor's
worker lifecycle and every serving replica's pull/swap all record onto one
timeline, separated into per-thread tracks by the trace-event ``tid``.

Disabled cost is near zero by design: :func:`span` and :func:`instant`
read one attribute and return a shared no-op object — no allocation, no
lock, no clock read.  Nothing in the hot path pays for telemetry until it
is switched on.

Event model (the subset of the Chrome trace-event format perfetto loads):

- ``B``/``E`` duration pairs per (pid, tid) — spans nest per thread track;
  a ``B`` carries its ``span_id`` and, under ``parent``, the id of the
  span that caused it (the innermost span open on its thread, or the one
  a hand-off to another thread named: :func:`caused_by`); an ``E`` carries
  the args that :meth:`Span.set` gave after the span opened
- ``i`` instant events (chaos fault fires, deploy swaps, train resume)
- ``M`` metadata events naming the process and each thread track

Activation:

- in-process: :func:`enable` (optionally with an export path)
- by environment — the multi-process protocol:
  ``OPENCHK_TRACE=/path/trace.json`` writes one file at process exit;
  ``OPENCHK_TRACE_DIR=/dir`` writes ``trace-<pid>.json`` into the shared
  dir, so a supervisor and its (restarted) workers each contribute a file
  and :func:`merge_dir` folds them into one perfetto-loadable timeline.
  The env is read lazily on first use, so launchers may set it from CLI
  flags before the first traced operation.

Hard kills: ``os._exit`` skips atexit, so the chaos registry calls
:func:`flush` immediately before an exit-mode fault — the fault's instant
event (and every span before it) is on disk before the process dies, which
is what lets ``chktrace`` show fault → death → restart → resume end to
end.  :func:`flush` is idempotent and atomic (tmp + replace).

Timestamps are wall-clock microseconds (``time.time_ns``), the one
timebase that lines up across processes when files are merged.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

TRACE_ENV = "OPENCHK_TRACE"
TRACE_DIR_ENV = "OPENCHK_TRACE_DIR"

_PRIMITIVES = (str, int, float, bool)


def _now_us() -> int:
    return time.time_ns() // 1000


def _clean_args(args: Dict[str, Any]) -> Dict[str, Any]:
    """Trace args must be JSON-serializable; stringify anything exotic."""
    out = {}
    for k, v in args.items():
        out[k] = v if (v is None or isinstance(v, _PRIMITIVES)) else str(v)
    return out


class _NullSpan:
    """The disabled fast path: one shared, stateless, reusable no-op."""

    __slots__ = ()
    id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def event(self, name: str, **args: Any) -> None:
        return None

    def set(self, **args: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class Span:
    """An open ``B`` event; ``__exit__``/``end`` writes the matching ``E``.

    Spans are thread-affine (B/E pairs nest per tid), which is exactly the
    Chrome trace-event contract — cross-thread stages (Plan on the caller,
    the tail on the CP thread) are separate spans joined by ``parent``."""

    __slots__ = ("tracer", "name", "id", "_tid", "_done", "_args")

    def __init__(self, tracer: "Tracer", name: str, span_id: int, tid: int):
        self.tracer = tracer
        self.name = name
        self.id = span_id
        self._tid = tid
        self._done = False
        self._args: Optional[Dict[str, Any]] = None

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def set(self, **args: Any) -> None:
        """Args known only once the span's work is done (bytes read);
        they ride the ``E`` event."""
        self._args = dict(self._args or {}, **_clean_args(args))

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        _pop(self.id)
        ev: Dict[str, Any] = {"ph": "E", "ts": _now_us(),
                              "pid": os.getpid(), "tid": self._tid}
        if self._args:
            ev["args"] = self._args
        self.tracer._record(ev)

    def event(self, name: str, **args: Any) -> None:
        """An instant inside this span's track."""
        self.tracer.instant(name, **args)


#: per thread, the ids of its open spans (and of a span that handed it
#: work, :func:`caused_by`), innermost last; touched only while tracing
_OPEN = threading.local()


def _stack() -> List[int]:
    st = getattr(_OPEN, "ids", None)
    if st is None:
        st = _OPEN.ids = []
    return st


def _pop(span_id: int) -> None:
    st = _stack()
    if st and st[-1] == span_id:
        st.pop()
    elif span_id in st:
        st.remove(span_id)


class Tracer:
    """Event recorder + exporter.  All mutation is under one lock; the
    disabled path never takes it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._named_tids: set = set()
        self._next_id = 0
        self._path: Optional[str] = None
        self._atexit_armed = False
        self._env_checked = False
        self.enabled = False

    # -- activation ------------------------------------------------------ #

    def _check_env(self) -> None:
        """Lazy one-shot env activation (subprocess protocol)."""
        with self._lock:
            if self._env_checked:
                return
            self._env_checked = True
        path = os.environ.get(TRACE_ENV, "")
        d = os.environ.get(TRACE_DIR_ENV, "")
        if not path and d:
            path = os.path.join(d, f"trace-{os.getpid()}.json")
        if path:
            self.enable(path)

    def ensure_enabled_checked(self) -> bool:
        """→ whether tracing is on, reading the env protocol on first call."""
        if not self._env_checked:
            self._check_env()
        return self.enabled

    def enable(self, path: Optional[str] = None) -> None:
        """Start recording; with *path*, also flush there at process exit."""
        with self._lock:
            self._env_checked = True
            self._path = path or self._path
            self.enabled = True
            arm = self._path is not None and not self._atexit_armed
            if arm:
                self._atexit_armed = True
        if arm:
            atexit.register(self.flush)
        self._record({"ph": "M", "name": "process_name",
                      "ts": _now_us(), "pid": os.getpid(), "tid": 0,
                      "args": {"name": " ".join(sys.argv[:3]) or "python"}})

    def disable(self) -> None:
        with self._lock:
            self.enabled = False

    def reset(self) -> None:
        """Drop recorded events (and named-thread memory); keep settings."""
        with self._lock:
            self._events = []
            self._named_tids = set()

    # -- recording ------------------------------------------------------- #

    def _record(self, ev: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append(ev)

    def _track(self) -> int:
        """Current thread's tid, emitting its name metadata once."""
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._named_tids:
            with self._lock:
                first = tid not in self._named_tids
                self._named_tids.add(tid)
            if first:
                self._record({"ph": "M", "name": "thread_name",
                              "ts": _now_us(), "pid": os.getpid(),
                              "tid": tid, "args": {"name": t.name}})
        return tid

    def span(self, name: str, cat: str = "openchk", **args: Any):
        """Open a span (context manager).  Disabled → shared no-op."""
        if not self.ensure_enabled_checked():
            return NULL_SPAN
        tid = self._track()
        with self._lock:
            self._next_id += 1
            sid = self._next_id
        ev: Dict[str, Any] = {"ph": "B", "name": name, "cat": cat,
                              "ts": _now_us(), "pid": os.getpid(),
                              "tid": tid}
        ev["args"] = dict(_clean_args(args), span_id=sid)
        st = _stack()
        if st:
            ev["args"]["parent"] = st[-1]
        st.append(sid)
        self._record(ev)
        return Span(self, name, sid, tid)

    def instant(self, name: str, cat: str = "openchk", scope: str = "t",
                **args: Any) -> None:
        """A zero-duration marker on the current thread's track."""
        if not self.ensure_enabled_checked():
            return
        self._record({"ph": "i", "name": name, "cat": cat, "s": scope,
                      "ts": _now_us(), "pid": os.getpid(),
                      "tid": self._track(),
                      "args": _clean_args(args)})

    # -- export ---------------------------------------------------------- #

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_json(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str, clear: bool = False) -> str:
        """Atomically write the trace to *path* (tmp + replace)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f)
        os.replace(tmp, path)
        if clear:
            self.reset()
        return path

    def flush(self) -> Optional[str]:
        """Write to the configured path, if any.  Safe pre-``os._exit``:
        never raises (a dying process must die, not hang on telemetry)."""
        with self._lock:
            path = self._path
        if path is None:
            return None
        try:
            return self.export(path)
        except OSError:
            return None

    def trace_dir(self) -> Optional[str]:
        """The shared multi-process dir, when env-activated with one."""
        self.ensure_enabled_checked()
        return os.environ.get(TRACE_DIR_ENV) or None


# -- module-level singleton + conveniences ---------------------------------
_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.ensure_enabled_checked()


def enable(path: Optional[str] = None) -> None:
    _TRACER.enable(path)


def disable() -> None:
    _TRACER.disable()


def span(name: str, cat: str = "openchk", **args: Any):
    if not _TRACER.enabled and _TRACER._env_checked:
        return NULL_SPAN                     # the hot no-op path
    return _TRACER.span(name, cat=cat, **args)


def instant(name: str, cat: str = "openchk", **args: Any) -> None:
    if not _TRACER.enabled and _TRACER._env_checked:
        return
    _TRACER.instant(name, cat=cat, **args)


def current_id() -> Optional[int]:
    """Id of the innermost span open on this thread (None when tracing is
    off or none is open): what a hand-off to another thread passes on."""
    if not _TRACER.enabled:
        return None
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def caused_by(span_id: Optional[int]):
    """Spans opened on this thread inside the block (and not inside
    another of its spans) record ``span_id`` as their ``parent``: the
    CP thread's tail names the store call that submitted it."""
    if span_id is None:
        yield
        return
    st = _stack()
    st.append(span_id)
    try:
        yield
    finally:
        _pop(span_id)


def export(path: str, clear: bool = False) -> str:
    return _TRACER.export(path, clear=clear)


def flush() -> Optional[str]:
    return _TRACER.flush()


def reset() -> None:
    _TRACER.reset()


def merge_dir(trace_dir: str, out_path: Optional[str] = None) -> Optional[str]:
    """Fold every ``trace-*.json`` under *trace_dir* into one file.

    Chrome trace events carry their pid, so merging is concatenation —
    perfetto renders each contributing process as its own track group.
    Unreadable files are skipped (a worker killed mid-write must not
    break the supervisor's merge).  → the merged path, or None if the
    dir held no readable events."""
    events: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(trace_dir))
    except OSError:
        return None
    for fn in names:
        if not (fn.startswith("trace-") and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(trace_dir, fn), encoding="utf-8") as f:
                events.extend(json.load(f).get("traceEvents", []))
        except (OSError, ValueError):
            continue
    if not events:
        return None
    out_path = out_path or os.path.join(trace_dir, "trace.json")
    tmp = f"{out_path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, out_path)
    return out_path
