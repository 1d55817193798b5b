"""Fault injection (evaluation methodology §6.1: deterministic fault at 90 %
of application progress, then restart until successful completion).

This is the *legacy* single-fault injector. The general harness —
scheduled, probabilistic and repeating faults at named sites across the
whole stack — lives in :mod:`repro_torch.chaos.inject`; the env protocol here
(``OPENCHK_INJECT_AT``) is kept as a back-compat shim over it."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from repro_torch.chaos.inject import legacy_inject_at


class SimulatedFault(RuntimeError):
    """Process-abort analogue (the paper injects exceptions that abort)."""


@dataclass
class FaultInjector:
    total_steps: int
    at_progress: float = 0.9          # paper: faults at 90 % progress
    fire_once: bool = True
    hard: bool = False                # True → os._exit (real process abort)
    _fired: bool = False

    @property
    def fault_step(self) -> int:
        return max(1, int(self.total_steps * self.at_progress))

    def maybe_fail(self, step: int) -> None:
        if self._fired and self.fire_once:
            return
        if step == self.fault_step:
            self._fired = True
            if self.hard:
                os._exit(39)          # distinguishable abort code
            raise SimulatedFault(
                f"injected fault at step {step} "
                f"({self.at_progress:.0%} progress)")


def should_inject_from_env() -> Optional[float]:
    """Launcher protocol: OPENCHK_INJECT_AT=0.9 enables injection in child
    training processes (used by launch/train.py --supervise).

    Back-compat shim over :func:`repro_torch.chaos.inject.legacy_inject_at`: a
    malformed value warns and returns None instead of raising ValueError
    at launcher import time (new code should arm ``OPENCHK_CHAOS`` specs
    at site ``train.step`` instead)."""
    return legacy_inject_at(os.environ)
