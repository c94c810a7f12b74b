"""The traced window: `torch.profiler` over the card, reduced
to the device's busy time, each kernel's device time, and the idle time
between device operations by what the host was doing.

Kineto stamps every event in wall-clock nanoseconds; the program's spans
and the benchmark's own are `time.perf_counter()` stamps, so the window
records both clocks at its start and maps one onto the other."""

from __future__ import annotations

import gc
import time


class TracedWindow:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0 = self.t1 = 0.0

    def __enter__(self):
        self.gc_spans = []
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            # the card's activity only: the host's side is the spans' (a host
            # activity would record every operator call and cost the window)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            gc.callbacks.append(self._gc)
        self.wall0 = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.t1 = time.perf_counter()
        if self.prof is not None:
            gc.callbacks.remove(self._gc)
            self.prof.__exit__(et, ev, tb)
        return False

    def _gc(self, phase: str, info: dict) -> None:
        """The cyclic collector's pauses, as spans deeper than any other."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_spans.append((f"gc{info.get('generation', '')}", self._gc_t0, time.perf_counter(), 1 << 10))

    def device_events(self) -> list[tuple[str, int, int]]:
        """(name, start ns, end ns) of every operation that ran on the card
        within the window (kernels, copies, fills), in the perf_counter
        time base (ns)."""
        from torch.autograd import DeviceType

        off = int(self.t0 * 1e9) - self.wall0
        lo, hi = int(self.t0 * 1e9), int(self.t1 * 1e9)
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s = ev.start_ns() + off
            e = s + ev.duration_ns()
            s, e = max(s, lo), min(e, hi)
            if e > s:
                out.append((ev.name(), s, e))
        return out

    def summary(self, spans: list[tuple[str, float, float, int]]) -> dict:
        """busy_s, window_s, kernel seconds and launches by name, and the breakdown:
        the 10 device operations that took most time, and the idle time
        summed by the host activity (the deepest span) it fell under, the 10
        largest. `spans` are (name, start s, end s, depth) in the
        perf_counter time base."""
        events = self.device_events()
        lo, hi = int(self.t0 * 1e9), int(self.t1 * 1e9)
        by_name: dict[str, float] = {}
        launches: dict[str, int] = {}
        for name, s, e in events:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
            launches[name] = launches.get(name, 0) + 1
        busy, gaps, cur = 0, [], lo
        for _name, s, e in sorted(events, key=lambda x: x[1]):
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if hi > cur:
            gaps.append((cur, hi))
        idle: dict[str, float] = {}
        segments = _host_activity(list(spans) + self.gc_spans)
        k = 0
        for g0, g1 in gaps:
            a, b = g0 / 1e9, g1 / 1e9
            while k < len(segments) and segments[k][1] <= a:
                k += 1
            j, covered = k, 0.0
            while j < len(segments) and segments[j][0] < b:
                s0, s1, label = segments[j]
                part = min(b, s1) - max(a, s0)
                if part > 0:
                    idle[label] = idle.get(label, 0.0) + part
                    covered += part
                j += 1
            if b - a - covered > 0:
                idle["other"] = idle.get("other", 0.0) + (b - a - covered)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "kernels": by_name, "launches": launches,
                "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}


def _host_activity(spans) -> list[tuple[float, float, str]]:
    """The host's timeline as (start, end, name) segments, in order: each
    piece of time named by the deepest span covering it."""
    edges = sorted({t for _n, s, e, _d in spans for t in (s, e)})
    ordered = sorted(spans, key=lambda x: x[1])
    out, active, k = [], [], 0
    for t0, t1 in zip(edges, edges[1:]):
        while k < len(ordered) and ordered[k][1] <= t0:
            active.append(ordered[k])
            k += 1
        active = [sp for sp in active if sp[2] >= t1]
        if active:
            out.append((t0, t1, max(active, key=lambda sp: sp[3])[0]))
    return out


def trace_spans(traces, label: str = "solve") -> list[tuple[str, float, float, int]]:
    """The spans of the program's flight records (`SolveTrace`), each named
    by its path from the solve ("solve/pack/scan"), with the solve itself."""
    out = []

    def walk(span, path, depth):
        name = f"{path}/{span.name}"
        out.append((name, span.t0, span.t0 + span.dur, depth))
        for c in span.children:
            walk(c, name, depth + 1)

    for tr in traces:
        out.append((label, tr.t0, tr.t0 + tr.duration, 1))
        for s in tr.spans:
            walk(s, label, 2)
    return out
