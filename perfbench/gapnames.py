"""The card's idle gaps named after what the program was doing, as well
as the benchmark's phase around it.

``devtrace.reduce_intervals`` names a gap after the innermost phase
(``mark(<phase>)``) that holds its middle.  The program's own spans
(``repro_torch.telemetry.trace``, on in a ``--trace 1`` run) are on the
same host clock, so the marker offset that shifts the phases onto the
profiler's clock shifts them too.  A gap is cut where a phase or a span
begins or ends (one gap of the card can last from a restore's read
through its decode), and each piece is named

- ``<phase>/<span>``: after the innermost span of the window's thread
  that holds its middle (``recover/restore.read``, ``store/plan.d2h``);
- ``<phase>+<span>``: else after the innermost span of another thread
  that does (``step+pipeline.pack``: the CP thread packing over a step);
- ``<phase>``: else.

    python3 perfbench/gapnames.py --workload <cell> --seed <n> \\
        --seconds <s> --trace 1

runs the benchmark's command with its device trace reduced this way, so
that the line's ``breakdown`` carries these names.
"""
from __future__ import annotations

import bisect
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

T0 = time.time()
if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import devtrace, spans  # noqa: E402

Interval = Tuple[str, float, float]


def name_gaps(device: List[Interval], ranges: List[Interval],
              program: List[Tuple[str, int, float, float]],
              tid: int) -> Optional[Dict]:
    """``reduce_intervals`` of the device activities and the phases, with
    the idle gaps named after ``program``'s spans (name, thread, start,
    end) as well; ``tid`` is the window's thread.  All in microseconds on
    one clock."""
    out = devtrace.reduce_intervals(device, ranges)
    if out is None:
        return None
    w0, w1 = next((a, b) for n, a, b in ranges if n == "window")
    busy = devtrace._merge([(max(a, w0), min(b, w1)) for _, a, b in device
                            if min(b, w1) > max(a, w0)])
    phases = sorted((r for r in ranges if r[0] != "window"),
                    key=lambda r: r[2] - r[1])
    by_len = sorted(program, key=lambda s: s[3] - s[2])
    own = [s for s in by_len if s[1] == tid]
    other = [s for s in by_len if s[1] != tid]
    cuts = sorted({x for r in phases for x in r[1:]} |
                  {x for sp in program for x in sp[2:]})

    def holding(items, mid):
        return next((s[0] for s in items if s[-2] <= mid <= s[-1]), None)

    def named(mid):
        name = holding(phases, mid) or "other"
        mine = holding(own, mid)
        if mine:
            return f"{name}/{mine}"
        theirs = holding(other, mid)
        return f"{name}+{theirs}" if theirs else name

    idle: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        inner = cuts[bisect.bisect_right(cuts, a):
                     bisect.bisect_left(cuts, b)]
        pieces = [a] + inner + [b]
        for x, y in zip(pieces, pieces[1:]):
            name = named((x + y) / 2)
            idle[name] = idle.get(name, 0.0) + (y - x) / 1e6
    out["idle_by_phase"] = idle
    return out


def reduce_named(device_ns: List[Interval], marker_ns: Optional[int],
                 ranges_ns: List[Interval], events: List[Dict],
                 tid: int) -> Optional[Dict]:
    """``DeviceTrace.reduce`` with the program's span events: the device's
    activities (nanoseconds on the profiler's clock), the host time at
    which the marker kernel was launched, the phases (nanoseconds on the
    host's clock) and the tracer's events (microseconds on the host's);
    one offset, from the marker, moves the phases and the spans alike."""
    offset = 0
    marks = [d for d in device_ns if devtrace.MARKER in d[0]]
    if marks and marker_ns is not None:
        first = min(marks, key=lambda d: d[1])
        if abs(first[1] - marker_ns) > 1_000_000:
            offset = first[1] - marker_ns
    ranges = [(n, (a + offset) / 1e3, (b + offset) / 1e3)
              for n, a, b in ranges_ns]
    program = [(s["name"], s["tid"], s["ts"] + offset / 1e3,
                s["end"] + offset / 1e3) for s in spans.closed(events)]
    return name_gaps([(n, a / 1e3, b / 1e3) for n, a, b in device_ns],
                     ranges, program, tid)


def _device_ns(dt: devtrace.DeviceTrace) -> List[Interval]:
    if dt.prof is None:
        return []
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in dt.prof.profiler.kineto_results.events()
            if str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"]


def main() -> int:
    from perfbench import harness
    from repro_torch.telemetry import trace as ttrace

    tid = threading.get_ident()          # the harness runs the window here

    def reduce(dt):
        if not dt.enabled:
            return None
        return reduce_named(_device_ns(dt), dt.marker_ns, dt.ranges,
                            ttrace.tracer().events(), tid)

    devtrace.DeviceTrace.reduce = reduce
    return harness.main(t0=T0)


if __name__ == "__main__":
    sys.exit(main())
