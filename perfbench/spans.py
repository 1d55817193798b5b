"""The program's spans as a ``--trace 1`` run recorded them
(``repro_torch.telemetry.trace``: ``B``/``E`` events, microseconds on the
host's clock), for the readers of ``program_span`` metrics.

Spans nest per thread: an ``E`` event closes the innermost span its
thread opened, and its args (what the span learnt once its work was done,
such as the bytes a read returned) join the ``B`` event's.  A program
without a span leaves its metric with nothing to read: the readers then
return None.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def closed(events: List[Dict]) -> List[Dict]:
    """→ [{"name", "tid", "ts", "end", "args"}] of every closed span, in
    the order they opened."""
    stacks: Dict[int, List[Dict]] = {}
    out = []
    for ev in events:
        if ev["ph"] == "B":
            sp = {"name": ev["name"], "tid": ev["tid"], "ts": ev["ts"],
                  "end": None, "args": dict(ev.get("args", {}))}
            stacks.setdefault(ev["tid"], []).append(sp)
            out.append(sp)
        elif ev["ph"] == "E" and stacks.get(ev["tid"]):
            sp = stacks[ev["tid"]].pop()
            sp["end"] = ev["ts"]
            sp["args"].update(ev.get("args", {}))
    return [s for s in out if s["end"] is not None]


def seconds(events: List[Dict], name: str) -> List[float]:
    """The durations of the spans named ``name``, in seconds."""
    return [(s["end"] - s["ts"]) / 1e6 for s in closed(events)
            if s["name"] == name]


def gbps(events: List[Dict], timed: str,
         counted: Optional[str] = None) -> Optional[float]:
    """The ``bytes`` args of the spans named ``counted`` (default
    ``timed``) over the summed duration of those named ``timed``, in
    GB/s; None where either is missing."""
    spans = closed(events)
    moved = sum(s["args"].get("bytes", 0) for s in spans
                if s["name"] == (counted or timed))
    secs = sum((s["end"] - s["ts"]) / 1e6 for s in spans
               if s["name"] == timed)
    if moved <= 0 or secs <= 0:
        return None
    return moved / secs / 1e9
