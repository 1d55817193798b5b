"""CP-dedicated threads (paper §4.2.2).

One thread per host runs the checkpoint pipeline's Pack → Place → Commit
tail — serialization, redundancy, I/O — while the accelerator keeps
computing.  The Plan stage always stays on the training thread, in
submission order; that is the only synchronous cost: the device→host
snapshot, plus — for CHK_DIFF — the on-device blockhash/pack at HBM
bandwidth (clean leaves are skipped via the identity cache).  FULL stores
defer their digest bookkeeping to this thread behind a fence (a later
DIFF plan waits for it; backends without checkpoint kinds skip digest
bookkeeping entirely).  FULL, DIFF and incremental stores all go
through the same queue, so they compose and serialize correctly against
each other.

FTI semantics for errors: a failed asynchronous store does not raise at the
original ``store()`` call; it is surfaced at the *next* directive (store /
load / shutdown) — exposed via ``check_errors``/``wait``.
"""
from __future__ import annotations

import queue
import threading
import traceback
import weakref
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from repro_torch.telemetry import trace as ttrace

_LIVE: "weakref.WeakSet[CPDedicatedThread]" = weakref.WeakSet()


def drain_all() -> None:
    """Fence every live CP thread. In-process fault *simulation* leaves the
    faulted context's thread alive (a real abort kills it with the process);
    test/bench harnesses call this between attempts so the restarted run
    never races an orphaned writer."""
    for cp in list(_LIVE):
        try:
            cp.wait()
        except Exception:  # noqa: BLE001 — draining best-effort
            pass


@dataclass
class AsyncResult:
    ckpt_id: int
    done: threading.Event
    error: Optional[BaseException] = None
    report: Any = None


class CPDedicatedThread:
    """Single dedicated worker; at most ``max_inflight`` pending stores
    (further submits block — matches FTI's head-of-line checkpoint fence)."""

    def __init__(self, max_inflight: int = 1, name: str = "openchk-cp"):
        self._q: "queue.Queue" = queue.Queue()
        self._results: List[AsyncResult] = []
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._max_inflight = max_inflight
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._alive = True
        self._thread.start()
        _LIVE.add(self)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, res, cause = item
            try:
                with ttrace.caused_by(cause):
                    res.report = fn()
            except BaseException as e:   # noqa: BLE001 — surfaced later
                res.error = e
                with self._lock:
                    self._errors.append(e)
                traceback.print_exc()
            finally:
                res.done.set()
                self._q.task_done()

    # ------------------------------------------------------------------ #

    def inflight(self) -> int:
        with self._lock:
            return sum(0 if r.done.is_set() else 1 for r in self._results)

    def submit(self, ckpt_id: int, fn: Callable[[], Any]) -> AsyncResult:
        """Queue ``fn`` behind the fence; the spans it opens on this thread
        name the caller's open span (the store call) as their parent."""
        if not self._alive:
            raise RuntimeError("CP thread already shut down")
        cause = ttrace.current_id()
        with ttrace.span("cp.submit", ckpt_id=ckpt_id):
            # fence: keep at most max_inflight pending
            while self.inflight() >= self._max_inflight:
                self._wait_one()
            res = AsyncResult(ckpt_id, threading.Event())
            with self._lock:
                self._results.append(res)
            self._q.put((fn, res, cause))
        return res

    def _wait_one(self) -> None:
        with self._lock:
            pending = [r for r in self._results if not r.done.is_set()]
        if pending:
            pending[0].done.wait()

    def wait(self) -> None:
        """Drain all pending stores (pre-shutdown / pre-restart fence)."""
        while self.inflight():
            self._wait_one()

    def check_errors(self) -> None:
        """Raise the first deferred error (FTI-style late surfacing)."""
        with self._lock:
            errs, self._errors = self._errors, []
        if errs:
            raise RuntimeError(
                f"asynchronous checkpoint failed: {errs[0]!r}") from errs[0]

    def shutdown(self) -> None:
        if self._alive:
            self.wait()
            self._q.put(None)
            self._thread.join(timeout=30)
            self._alive = False
