"""Heartbeat failure detector for the restart launcher.

The training process touches a heartbeat file every step; the launcher
watches mtime and declares the worker dead after ``timeout`` seconds —
covering hangs, not just aborts (aborts are caught by exit status).
At 1000+ nodes the same protocol runs per-host with the launcher feeding a
cluster-level scheduler; the file-based local form keeps the logic testable.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.chaos import inject as chaos


@dataclass
class Heartbeat:
    path: str

    def beat(self, step: Optional[int] = None) -> None:
        # chaos site: a "skip"-mode spec models a worker whose heartbeat
        # writes stop landing (hung I/O) while the process is still alive
        if chaos.fire(chaos.SITES.HEARTBEAT, step=step).skipped:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{time.time()} {step if step is not None else -1}")
            # fsync before the rename: a host crash must not leave a
            # fresh-mtime/empty-content heartbeat that masks a dead worker
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def last(self) -> Optional[float]:
        try:
            return float(open(self.path).read().split()[0])
        except (OSError, ValueError, IndexError):
            return None

    def last_step(self) -> Optional[int]:
        try:
            return int(open(self.path).read().split()[1])
        except (OSError, ValueError, IndexError):
            return None

    def stale_s(self) -> Optional[float]:
        """Seconds since the last beat landed (None if none ever did)."""
        t = self.last()
        return None if t is None else time.time() - t


@dataclass
class HeartbeatMonitor:
    hb: Heartbeat
    timeout: float = 60.0

    def alive(self) -> bool:
        s = self.hb.stale_s()
        return s is not None and s < self.timeout
