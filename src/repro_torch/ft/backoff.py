"""Shared exponential backoff — the retry policy proven in serve/deploy.

One formula, used by the deployer's pinned-replica retries and the
launcher's restart loop: delay for the N-th consecutive failure is
``base * 2**(N-1)`` capped at ``max_s``. Kept as both a pure function
(:func:`backoff_delay`, for callers that track their own failure count)
and a small stateful helper (:class:`ExponentialBackoff`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


def backoff_delay(failures: int, base_s: float = 1.0,
                  max_s: float = 30.0) -> float:
    """Delay after the *failures*-th consecutive failure (1-based)."""
    if failures <= 0:
        return 0.0
    return min(base_s * (2 ** (failures - 1)), max_s)


@dataclass
class ExponentialBackoff:
    """Counts consecutive failures; ``failed()`` returns the next delay."""

    base_s: float = 1.0
    max_s: float = 30.0
    failures: int = field(default=0, init=False)

    def failed(self) -> float:
        self.failures += 1
        return self.delay()

    def delay(self) -> float:
        return backoff_delay(self.failures, self.base_s, self.max_s)

    def reset(self) -> None:
        self.failures = 0

    def note_healthy_span(self, span_s: float, reset_after_s: float) -> bool:
        """Forget past failures once the caller has stayed healthy for
        *span_s* >= *reset_after_s* — one early crash must not tax every
        later restart at full exponential price.  Returns True iff the
        counter was actually reset."""
        if self.failures and span_s >= reset_after_s:
            self.reset()
            return True
        return False

    def sleep_after_failure(self, sleep_fn=time.sleep) -> float:
        d = self.failed()
        if d > 0:
            sleep_fn(d)
        return d
