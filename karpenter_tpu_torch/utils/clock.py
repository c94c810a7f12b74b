"""Injectable clocks (reference: k8s.io/utils/clock usage, e.g. provisioner.go:96).

Every controller takes a Clock so tests are fully deterministic — the same
fake-clock discipline the reference uses throughout its suites.
"""

from __future__ import annotations

import time

from ..obs.racecheck import make_lock


class Clock:
    def now(self) -> float:
        return time.time()

    def since(self, t: float) -> float:
        return self.now() - t

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """Deterministic clock; step() advances time manually."""

    GUARDED_FIELDS = {"_t": "_lock"}

    def __init__(self, start: float = 1_000_000.0):
        self._t = start
        self._lock = make_lock("clock")

    def now(self) -> float:
        with self._lock:
            return self._t

    def step(self, seconds: float) -> None:
        with self._lock:
            self._t += seconds

    def set(self, t: float) -> None:
        with self._lock:
            self._t = t

    def sleep(self, seconds: float) -> None:
        self.step(seconds)
