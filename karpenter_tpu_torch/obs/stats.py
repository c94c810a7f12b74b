"""Shared quantile math for every latency surface in the repo.

One nearest-rank implementation serves the e2e harness
(`testing/metrics_poller._p95`), the solvetrace rolling P50/P90/P99 windows
(`obs.trace.TraceRecorder`), and any test asserting exact quantile values.
The previous poller-local `round(q * (n - 1))` rule UNDERESTIMATES at small
n (n=13, q=0.95: round(11.4) -> the 12th sample instead of the 13th) and
inherits banker's-rounding surprises; nearest-rank is the Prometheus/NIST
definition — the smallest sample v such that at least ceil(q*n) samples
are <= v — and always returns a real sample, never an interpolation.
"""

from __future__ import annotations

import math


def quantile(values, q: float, assume_sorted: bool = False) -> float:
    """Nearest-rank quantile of `values` (any iterable of floats).

    Returns the ceil(q*n)-th smallest sample (1-based), clamped to the
    sample range; 0.0 for an empty input — matching the poller's historical
    empty-stats contract."""
    ordered = list(values) if assume_sorted else sorted(values)
    n = len(ordered)
    if n == 0:
        return 0.0
    idx = min(n - 1, max(0, math.ceil(q * n) - 1))
    return ordered[idx]


class RollingQuantiles:
    """A bounded window of observations with nearest-rank quantile reads.

    Append is O(1) (ring semantics via a capped list + cursor); quantile
    reads sort on demand — callers that read several quantiles at once
    should use `snapshot()` to pay the sort once."""

    __slots__ = ("_cap", "_items", "_head")

    def __init__(self, capacity: int):
        self._cap = max(1, int(capacity))
        self._items: list[float] = []
        self._head = 0

    def append(self, value: float) -> None:
        if len(self._items) < self._cap:
            self._items.append(float(value))
            return
        self._items[self._head] = float(value)
        self._head = (self._head + 1) % self._cap

    def __len__(self) -> int:
        return len(self._items)

    def snapshot(self) -> list[float]:
        """The window's samples, sorted ascending (one sort per read batch)."""
        return sorted(self._items)

    def quantile(self, q: float) -> float:
        return quantile(self.snapshot(), q, assume_sorted=True)
