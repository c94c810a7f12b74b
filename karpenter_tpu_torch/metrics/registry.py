"""Dependency-free Prometheus-style metrics registry.

Reference: pkg/metrics/metrics.go (karpenter_ namespace counters/gauges/
histograms registered on the controller-runtime registry) — rebuilt as a
small in-process registry with text exposition, since this control plane
is not a Go binary. Metric names/labels mirror the reference
so dashboards port over.
"""

from __future__ import annotations

import math
from bisect import bisect_left

from ..obs.racecheck import make_rlock

NAMESPACE = "karpenter"

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)
DURATION_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600)


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


class _Metric:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = make_rlock("metric")

    def _check(self, labels: dict[str, str]) -> dict[str, str]:
        extra = set(labels) - set(self.label_names)
        if extra:
            raise ValueError(f"{self.name}: unknown labels {extra}")
        return {k: str(labels.get(k, "")) for k in self.label_names}


class Counter(_Metric):
    TYPE = "counter"
    GUARDED_FIELDS = {"_values": "_lock"}

    def __init__(self, name, help_, label_names):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        labels = self._check(labels)
        with self._lock:
            key = _label_key(labels)
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(self._check(labels)), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def collect(self):
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]


class Gauge(_Metric):
    TYPE = "gauge"
    GUARDED_FIELDS = {"_values": "_lock"}

    def __init__(self, name, help_, label_names):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        labels = self._check(labels)
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def add(self, amount: float, **labels) -> None:
        labels = self._check(labels)
        with self._lock:
            key = _label_key(labels)
            self._values[key] = self._values.get(key, 0.0) + amount

    def delete(self, **labels) -> None:
        with self._lock:
            self._values.pop(_label_key(self._check(labels)), None)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(self._check(labels)), 0.0)

    def collect(self):
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]


class Histogram(_Metric):
    TYPE = "histogram"
    GUARDED_FIELDS = {"_counts": "_lock", "_sums": "_lock", "_totals": "_lock"}

    def __init__(self, name, help_, label_names, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}  # per-bucket cumulative-style on collect
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        labels = self._check(labels)
        with self._lock:
            key = _label_key(labels)
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            idx = bisect_left(self.buckets, value)
            if idx < len(counts):
                counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._totals.get(_label_key(self._check(labels)), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sums.get(_label_key(self._check(labels)), 0.0)

    def percentile(self, q: float, **labels) -> float:
        """Approximate quantile from bucket midpoints (for tests/monitoring)."""
        with self._lock:
            key = _label_key(self._check(labels))
            counts = self._counts.get(key)
            total = self._totals.get(key, 0)
        if not counts or total == 0:
            return math.nan
        target = q * total
        run = 0
        for i, c in enumerate(counts):
            run += c
            if run >= target:
                return self.buckets[i]
        return self.buckets[-1]

    def collect(self):
        with self._lock:
            out = []
            for key, counts in self._counts.items():
                cumulative, cum = [], 0
                for c in counts:
                    cum += c
                    cumulative.append(cum)
                out.append((dict(key), cumulative, self._totals[key], self._sums[key]))
            return out


class Registry:
    """get-or-create metric registry with prometheus text exposition."""

    GUARDED_FIELDS = {"_metrics": "_lock"}

    def __init__(self):
        self._lock = make_rlock("metric-registry")
        self._metrics: dict[str, _Metric] = {}

    def counter(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_, tuple(labels))

    def gauge(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, tuple(labels))

    def histogram(self, name: str, help_: str = "", labels: tuple[str, ...] = (), buckets=DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_, tuple(labels), buckets)
                self._metrics[name] = m
            if not isinstance(m, Histogram):
                raise TypeError(f"{name} is a {m.TYPE}, not a histogram")
            return m

    def _get_or_create(self, cls, name, help_, label_names):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, label_names)
                self._metrics[name] = m
            if not isinstance(m, cls):
                raise TypeError(f"{name} is a {m.TYPE}, not a {cls.TYPE}")
            return m

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text format (the /metrics endpoint payload)."""
        lines = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda x: x.name):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            if isinstance(m, Histogram):
                for labels, cumulative, total, sum_ in m.collect():
                    for bound, cum in zip(m.buckets, cumulative):
                        lines.append(_sample(f"{m.name}_bucket", {**labels, "le": _fmt(bound)}, cum))
                    lines.append(_sample(f"{m.name}_bucket", {**labels, "le": "+Inf"}, total))
                    lines.append(_sample(f"{m.name}_sum", labels, sum_))
                    lines.append(_sample(f"{m.name}_count", labels, total))
            else:
                for labels, v in m.collect():
                    lines.append(_sample(m.name, labels, v))
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))


def _sample(name: str, labels: dict, value) -> str:
    if labels:
        body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_fmt(float(value))}"
    return f"{name} {_fmt(float(value))}"
