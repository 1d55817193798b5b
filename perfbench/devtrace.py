"""What a ``--trace 1`` run reads from ``torch.profiler``: device time by
kernel name, the device's busy time over the window, and its idle gaps
named by what the host was doing (the benchmark's own phases,
``mark(<phase>)``, around the program's calls).

The profiler records the card's activities only (kernels, copies, sets),
so tracing costs the host little.  The phases are host times on the same
clock as the profiler's (nanoseconds since the epoch); a marker kernel
launched at a known host time gives the offset between the two, which is
taken out where it is over a millisecond.  A run with ``--trace 0``
starts no profiler and marks nothing.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

MARKER = "spin"


class DeviceTrace:
    def __init__(self, enabled: bool, device_type: str):
        self.enabled = enabled
        self.on_card = device_type == "cuda"
        self.prof = None
        self.ranges: List[Tuple[str, int, int]] = []
        self.marker_ns: Optional[int] = None

    def start(self) -> None:
        if not (self.enabled and self.on_card):
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_ns = time.time_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def mark(self, name: str):
        """Record the host phase ``name`` (nothing without a trace)."""
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.ranges.append((name, t0, time.time_ns()))

    def reduce(self) -> Optional[Dict]:
        """→ {"window_s", "busy_s", "kernels": {name: [count, s]},
        "idle_by_phase": {phase: s}} over the ``window`` phase, or None
        without a trace."""
        if not self.enabled:
            return None
        device = []
        if self.prof is not None:
            for e in self.prof.profiler.kineto_results.events():
                if str(e.device_type()).rsplit(".", 1)[-1] == "CUDA":
                    device.append((e.name(), e.start_ns(), e.end_ns()))
        offset = 0
        marks = [d for d in device if MARKER in d[0]]
        if marks and self.marker_ns is not None:
            first = min(marks, key=lambda d: d[1])
            if abs(first[1] - self.marker_ns) > 1_000_000:
                offset = first[1] - self.marker_ns
        ranges = [(n, (a + offset) / 1e3, (b + offset) / 1e3)
                  for n, a, b in self.ranges]
        return reduce_intervals(
            [(n, a / 1e3, b / 1e3) for n, a, b in device], ranges)


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_intervals(device: List[Tuple[str, float, float]],
                     ranges: List[Tuple[str, float, float]]) -> Optional[Dict]:
    """Device activities (name, start, end) and host ranges (phase, start,
    end), in microseconds on one clock → the window's numbers in seconds.
    An idle gap is named after the innermost host range (other than the
    window) that holds its middle, or ``other``."""
    win = [r for r in ranges if r[0] == "window"]
    if not win:
        return None
    w0, w1 = win[0][1], win[0][2]
    kernels: Dict[str, List] = {}
    spans = []
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        spans.append((a, b))
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    busy = _merge(spans)
    phases = sorted((r for r in ranges if r[0] != "window"),
                    key=lambda r: r[2] - r[1])
    idle: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = next((p for p, s, e in phases if s <= mid <= e), "other")
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernels": kernels, "idle_by_phase": idle}


def breakdown(reduced: Dict, top: int = 10) -> Dict:
    """The line's ``breakdown``: the device operations that took most time
    and the idle time by what the host was doing, at most ``top`` each."""
    ops = sorted(reduced["kernels"].items(), key=lambda kv: -kv[1][1])
    gaps = sorted(reduced["idle_by_phase"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:120], v[1]] for k, v in ops[:top]],
            "idle_gaps": [[k, v] for k, v in gaps[:top]]}


def kernel_time(reduced: Dict, pattern: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``pattern``."""
    n, s = 0, 0.0
    for name, (c, t) in reduced["kernels"].items():
        if pattern in name:
            n += c
            s += t
    return n, s
