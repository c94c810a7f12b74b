"""Metrics poller: periodic resource + metric sampling for e2e suites.

Reference: test/pkg/environment/common/karpenter_metrics_poller.go — the e2e
environment polls the controller's /metrics endpoint for process CPU/memory,
computes the CPU rate from process_cpu_seconds_total deltas, and reports
P95/avg/max stats the perf suites assert against. This runtime is
tick-driven, so `poll()` samples explicitly (call it per tick or on a timer);
metric families can additionally be sampled from the in-process Registry or
scraped over HTTP from the OperatorServer's /metrics exposition.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field


@dataclass
class ResourceSample:
    timestamp: float
    memory_mb: float  # process resident memory
    cpu_cores: float  # CPU usage rate since the previous sample


@dataclass
class ResourceStats:
    p95_memory_mb: float = 0.0
    avg_memory_mb: float = 0.0
    max_memory_mb: float = 0.0
    p95_cpu_cores: float = 0.0
    avg_cpu_cores: float = 0.0
    max_cpu_cores: float = 0.0
    sample_count: int = 0


def _rss_mb() -> float:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1024.0**2)
    except (OSError, ValueError, IndexError):
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _cpu_seconds() -> float:
    t = os.times()
    return t.user + t.system


def _p95(values: list[float]) -> float:
    # the repo's one nearest-rank quantile (obs/stats.py), shared with the
    # solvetrace rolling windows. The old round(0.95*(n-1)) rule here
    # underestimated at small n (n=13 returned the 12th sample, not the max)
    from ..obs.stats import quantile

    return quantile(values, 0.95)


class MetricsPoller:
    """Explicitly-driven sampler: `poll()` per tick; `stats()` at the end.

    `registry` (optional) also snapshots named metric families per poll so
    suites can assert over time series (the reference scrapes the Prometheus
    exposition for the same purpose)."""

    def __init__(self, registry=None, track: tuple = ()):
        self.registry = registry
        self.track = track  # metric names snapshotted per poll
        self.samples: list[ResourceSample] = []
        self.series: dict[str, list[float]] = {name: [] for name in track}
        self._last_cpu: float | None = None
        self._last_ts: float | None = None

    def poll(self) -> ResourceSample:
        now = time.monotonic()
        cpu_total = _cpu_seconds()
        rate = 0.0
        if self._last_cpu is not None and now > self._last_ts:
            rate = max(0.0, (cpu_total - self._last_cpu) / (now - self._last_ts))
        self._last_cpu, self._last_ts = cpu_total, now
        sample = ResourceSample(timestamp=now, memory_mb=_rss_mb(), cpu_cores=rate)
        self.samples.append(sample)
        for name in self.track:
            self.series[name].append(self._metric_value(name))
        return sample

    def _metric_value(self, name: str) -> float:
        m = self.registry.get(name) if self.registry is not None else None
        if m is None:
            return 0.0
        collect = m.collect()
        if not collect:
            return 0.0
        # counters/gauges: sum across label sets; histograms: total count
        first = collect[0]
        if len(first) == 2:  # (labels, value)
            return float(sum(v for _, v in collect))
        return float(sum(total for _, _, total, _ in collect))

    def stats(self) -> ResourceStats:
        if not self.samples:
            return ResourceStats()
        mems = [s.memory_mb for s in self.samples]
        cpus = [s.cpu_cores for s in self.samples[1:]] or [0.0]  # first has no rate
        return ResourceStats(
            p95_memory_mb=_p95(mems),
            avg_memory_mb=sum(mems) / len(mems),
            max_memory_mb=max(mems),
            p95_cpu_cores=_p95(cpus),
            avg_cpu_cores=sum(cpus) / len(cpus),
            max_cpu_cores=max(cpus),
            sample_count=len(self.samples),
        )


def scrape_exposition(text: str) -> dict[tuple, float]:
    """Parse Prometheus text exposition into {(name, ((label, value), ...)):
    value} — the HTTP-side analogue of Registry sampling, so e2e suites can
    assert against the OperatorServer's real /metrics payload."""
    out: dict[tuple, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, raw_value = line.rsplit(" ", 1)
            value = float(raw_value)
        except ValueError:
            continue
        if "{" in head:
            name, rest = head.split("{", 1)
            labels = []
            for pair in rest.rstrip("}").split(","):
                if not pair:
                    continue
                k, _, v = pair.partition("=")
                labels.append((k, v.strip('"')))
            out[(name, tuple(sorted(labels)))] = value
        else:
            out[(head, ())] = value
    return out
