"""solvetrace: a per-solve flight recorder for the scheduling solver.

Every `GPUSolver.solve` produces one `SolveTrace`: the mode/backend that
served it, a span tree of its phases (encode/pack/residual/decode, with the
host FFD's per-phase split attached when a fallback or residual ran), the
cache-hit attribution that explains WHY the solve took the path it did
(encode delta vs full, row-cache hit, FFD fit-memo stats, repair counts,
fallback reason families), and a kernel-library build stamp from the
sentinel below. Traces land in a bounded ring (`TraceRecorder`) that
maintains rolling P50/P90/P99 per (mode, phase), published as the
`karpenter_solver_solve_quantile_seconds` gauge family and dumped whole
via `TraceRecorder.dump` or the `python -m karpenter_tpu_torch.obs`
exporter.

Overhead contract: recording must never change placements (tests pin
bit-identical results tracing on vs off). The span API times with bare
`time.perf_counter()` pairs; a disabled recorder (KARPENTER_SOLVETRACE=0)
skips the span tree, ring, sentinel, collector hook and quantile
publication but keeps the flat per-phase totals so the
`last_phase_seconds` surface stays truthful either way.

The cyclic collector's pauses land in the trace of the thread they stop:
the first enabled `TraceRecorder.begin` installs one process-wide
`gc.callbacks` hook, which records a generation-2 pause as a `gc2` span
under the innermost open span and adds generation-0 and -1 pauses to the
`gc0` / `gc1` totals only (thousands of them a solve; a span each would
grow every trace the collector walks).

This module imports neither torch nor numpy: the sentinel reads the kernel
library's load counter through `sys.modules`, so building a trace never
initializes a device.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext

from ..utils.ringbuffer import RingBuffer
from .racecheck import make_lock
from .stats import RollingQuantiles, quantile

QUANTILE_NAMES = ("p50", "p90", "p99")
_QUANTILE_POINTS = {"p50": 0.50, "p90": 0.90, "p99": 0.99}

# The solver's kernel entry points, watched by the recompile sentinel:
# (fn label, module, attribute). Labels are the `fn` metric label values —
# a static enum by construction, the same as the JAX solver's. The port has
# no retrace: the event that stands in for one is a build or load of the
# kernel library (`kernels/build.py`), which holds every kernel; a load
# counts once, under the label of the innermost entry point below on the
# stack of the call that made it (`build.count_load`). Launches are not
# recompiles and are never counted here.
JIT_WATCHLIST = (
    ("pack_full", "karpenter_tpu_torch.models.scheduler_model_grouped", "greedy_pack_grouped_compressed"),
    ("pack_delta", "karpenter_tpu_torch.models.scheduler_model_grouped", "greedy_pack_delta_compressed"),
    ("pack_grouped", "karpenter_tpu_torch.models.scheduler_model_grouped", "greedy_pack_grouped"),
    ("recredit", "karpenter_tpu_torch.models.scheduler_model_grouped", "recredit_removals"),
    ("pack_perpod", "karpenter_tpu_torch.models.scheduler_model", "greedy_pack"),
    ("anneal", "karpenter_tpu_torch.models.consolidation_model", "anneal_chains"),
    ("lp_repack", "karpenter_tpu_torch.models.consolidation_model", "lp_repack"),
    ("lp_score", "karpenter_tpu_torch.models.consolidation_model", "score_subsets"),
    # the meshed pack's entry points (`parallel/sharded.py`): its slot-sharded
    # scan and its batch-sharded feasibility
    ("pack_sharded", "karpenter_tpu_torch.parallel.sharded", "pack_scan_sharded"),
    ("shard_feas", "karpenter_tpu_torch.parallel.sharded", "sharded_feasibility"),
)

_BUILD_MODULE = "karpenter_tpu_torch.kernels.build"


class RecompileSentinel:
    """Detects kernel-library builds and loads by diffing the library's
    per-entry load counters (`kernels.build.LOADS`) around each solve: one
    grows exactly when a call had to build the library with nvcc or load it
    from disk — the first use in a process, which is what a warm solve must
    never pay — and only the counter of the entry point that made the call.
    Labels whose entry module is not imported yet don't appear in the
    snapshot; neither does anything before `kernels.build` is imported."""

    def __init__(self, watchlist=JIT_WATCHLIST):
        self.watchlist = tuple(watchlist)

    def snapshot(self) -> dict[str, int]:
        build = sys.modules.get(_BUILD_MODULE)
        loads = getattr(build, "LOADS", None) if build is not None else None
        if not isinstance(loads, dict):
            return {}
        out: dict[str, int] = {}
        for label, modname, attr in self.watchlist:
            mod = sys.modules.get(modname)
            if mod is not None and getattr(mod, attr, None) is not None:
                out[label] = int(loads.get(label, 0))
        return out

    def delta(self, before: dict[str, int] | None) -> dict[str, int]:
        """Per-fn load increments since `before` (positive only)."""
        before = before or {}
        after = self.snapshot()
        return {k: v - before.get(k, 0) for k, v in after.items() if v > before.get(k, 0)}


_SENTINEL = RecompileSentinel()


def sentinel() -> RecompileSentinel:
    return _SENTINEL


class Span:
    """One timed phase. `t0` is a perf_counter stamp (exported relative to
    the owning trace's start); `attrs` carry small structured context like
    the encode mode."""

    __slots__ = ("name", "t0", "dur", "attrs", "children")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.t0 = 0.0
        self.dur = 0.0
        self.attrs = attrs
        self.children: list[Span] = []

    def to_dict(self, base: float) -> dict:
        d = {"name": self.name, "start_s": round(self.t0 - base, 6), "dur_s": round(self.dur, 6)}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict(base) for c in self.children]
        return d


class _SpanHandle:
    __slots__ = ("_trace", "span")

    def __init__(self, trace: "SolveTrace", span: Span):
        self._trace = trace
        self.span = span

    def __enter__(self) -> Span:
        tr = self._trace
        if tr.enabled:
            tr._attach(self.span)
            tr._stack.append(self.span)
        self.span.t0 = time.perf_counter()
        return self.span

    def __exit__(self, et, ev, tb):
        s = self.span
        s.dur = time.perf_counter() - s.t0
        tr = self._trace
        tr.phase_totals[s.name] = tr.phase_totals.get(s.name, 0.0) + s.dur
        if tr.enabled and tr._stack and tr._stack[-1] is s:
            tr._stack.pop()
        return False


class SolveTrace:
    """The flight record of one solve. Mutated in place by the solver's exit
    paths (mode/backend writes arrive through the `last_solve_mode` compat
    setters) and sealed by `TraceRecorder.commit`."""

    __slots__ = (
        "seq",
        "enabled",
        "wall_time",
        "t0",
        "duration",
        "mode",
        "backend",
        "n_pods",
        "n_sigs",
        "fallback_reasons",
        "attribution",
        "phase_totals",
        "spans",
        "_stack",
        "recompiles",
        "jit_before",
        "_gc_t0",
    )

    def __init__(self, seq: int = 0, enabled: bool = False, n_pods: int = 0):
        self.seq = seq
        self.enabled = enabled
        self.wall_time = time.time()
        self.t0 = time.perf_counter()
        self.duration = 0.0
        self.mode = ""
        self.backend = ""
        self.n_pods = n_pods
        self.n_sigs = 0
        self.fallback_reasons: list[str] = []
        self.attribution: dict = {}
        self.phase_totals: dict[str, float] = {}
        self.spans: list[Span] = []
        self._stack: list[Span] = []
        self.recompiles: dict[str, int] = {}
        self.jit_before: dict[str, int] | None = None
        # the start of the collection now running on this trace's thread
        self._gc_t0: float | None = None

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **attrs) -> _SpanHandle:
        return _SpanHandle(self, Span(name, attrs))

    def add_phase(self, name: str, t0: float, dur: float, **attrs) -> None:
        """Record an already-measured phase as a span from `t0` (a
        perf_counter stamp) lasting `dur`, under the innermost open span.
        The host FFD accumulates its per-pod phase split in counters; the
        caller places each total inside the interval it was measured in."""
        self.phase_totals[name] = self.phase_totals.get(name, 0.0) + dur
        if self.enabled:
            s = Span(name, attrs)
            s.t0 = t0
            s.dur = dur
            self._attach(s)

    def _attach(self, s: Span) -> None:
        parent = self._stack[-1] if self._stack else None
        (parent.children if parent is not None else self.spans).append(s)

    def note(self, **kv) -> None:
        """Attach cache-hit / fallback / repair attribution facts."""
        if self.enabled:
            self.attribution.update(kv)

    # -- reading -------------------------------------------------------------
    @property
    def families(self) -> list[str]:
        from ..solver.fallback import reason_family

        return sorted({reason_family(r) for r in self.fallback_reasons})

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "wall_time": self.wall_time,
            "mode": self.mode,
            "backend": self.backend,
            "n_pods": self.n_pods,
            "n_sigs": self.n_sigs,
            "duration_s": round(self.duration, 6),
            "phases": {k: round(v, 6) for k, v in self.phase_totals.items()},
            "spans": [s.to_dict(self.t0) for s in self.spans],
            "cache": dict(self.attribution),
            "fallback_reasons": list(self.fallback_reasons),
            "fallback_families": self.families,
            "recompiles": dict(self.recompiles),
        }

    def explain(self) -> str:
        """Answer "why did this solve go the way it did" from the recorded
        attribution — the human-facing rendering of the trace."""
        a = self.attribution
        lines = [
            f"solve #{self.seq}: mode={self.mode or '?'} backend={self.backend or '?'} "
            f"{self.duration * 1e3:.2f}ms, {self.n_pods} pods ({self.n_sigs} signatures)"
        ]
        phases = ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in sorted(self.phase_totals.items()))
        if phases:
            lines.append(f"  phases: {phases}")
        enc = a.get("encode_mode")
        if enc is not None:
            row = "hit" if a.get("row_cache") else "miss"
            lines.append(f"  encode: mode={enc} row_cache={row}")
        eb = a.get("event_batch")
        if eb:
            extra = f", window {eb['window_s'] * 1e3:.1f}ms" if "window_s" in eb else ""
            extra += f", sched wait {eb['sched_wait_s'] * 1e3:.1f}ms" if "sched_wait_s" in eb else ""
            lines.append(
                f"  events: {eb.get('count', 0)} traced watch event(s), oldest "
                f"{eb.get('oldest_age_s', 0.0) * 1e3:.1f}ms old at dispatch{extra} (podtrace: /debug/events)"
            )
        if self.mode in ("hybrid", "hybrid-delta"):
            lines.append(
                f"  why hybrid: pod-local fallback families {self.families} "
                f"flagged {a.get('residual_pods', '?')} residual pod(s); the tensor majority packed on device"
            )
        elif self.mode == "fallback":
            lines.append(f"  why fallback: {self.families} — whole snapshot on the host FFD")
        elif self.mode == "delta":
            refresh = " + row refresh" if a.get("row_refresh") else ""
            lines.append(
                f"  why delta: pod delta of the previous solve "
                f"(+{a.get('delta_added', 0)}/-{a.get('delta_removed', 0)} pods{refresh}) re-packed from device-resident state"
            )
        if a.get("delta_reject"):
            lines.append(
                f"  why not delta: {a['delta_reject']} — the delta classifier routed this solve to the full path"
            )
        if a.get("repair_pods"):
            lines.append(
                f"  repair: {a['repair_pods']} pod(s) of {a.get('repair_sigs', '?')} signature(s) "
                f"re-solved on the bounded host repair ({a.get('repair_reason', 'min-values')})"
            )
        memo = a.get("ffd_memo")
        if memo:
            probes = sum(memo.values()) or 1
            lines.append(f"  ffd memo: {memo} (hit rate {memo.get('hit', 0) / probes:.1%})")
        if self.recompiles:
            lines.append(f"  recompiles: {self.recompiles} — this solve paid a kernel-library build or load")
        else:
            lines.append("  recompiles: none")
        return "\n".join(lines)


_tls = threading.local()


def current_trace() -> SolveTrace | None:
    """The solve trace active on this thread, if any — how layers below the
    solver (host FFD scheduler, residual path) attach their phase splits
    without plumbing a trace argument through every signature."""
    return getattr(_tls, "trace", None)


def trace_span(name: str, **attrs):
    """A span on this thread's trace, or a context that does nothing when
    no solve is being traced: how the layers below the solver open their
    own spans."""
    tr = getattr(_tls, "trace", None)
    return tr.span(name, **attrs) if tr is not None else nullcontext()


_GC_TOTALS = ("gc0", "gc1", "gc2")
_gc_hook_lock = make_lock("gc_hook")


def _on_gc(phase: str, info: dict) -> None:
    """`gc.callbacks` hook: one pause of the cyclic collector, on the thread
    it stopped, recorded in that thread's trace when it is enabled. A
    generation-2 pause becomes a `gc2` span (with the objects it
    `collected`) under the innermost open span; every pause adds to its
    generation's total."""
    tr = getattr(_tls, "trace", None)
    if tr is None or not tr.enabled:
        return
    now = time.perf_counter()
    if phase == "start":
        tr._gc_t0 = now
        return
    t0, tr._gc_t0 = tr._gc_t0, None
    if t0 is None:
        # the trace began while a finalizer ran inside this pause
        return
    gen = info["generation"]
    name = _GC_TOTALS[gen]
    tr.phase_totals[name] = tr.phase_totals.get(name, 0.0) + (now - t0)
    if gen == 2:
        s = Span(name, {"collected": info["collected"]})
        s.t0 = t0
        s.dur = now - t0
        tr._attach(s)


def _install_gc_hook() -> None:
    """Add `_on_gc` to `gc.callbacks` unless it is there (the first enabled
    trace of the process installs it; it stays for the process's life)."""
    with _gc_hook_lock:
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)


def _env_enabled() -> bool:
    return os.environ.get("KARPENTER_SOLVETRACE", "1").strip().lower() not in ("0", "false", "off")


class TraceRecorder:
    """Bounded ring of the last `capacity` SolveTraces plus rolling
    per-(mode, phase) quantile windows. Thread-safe; one process-wide default
    instance serves every solver unless a private one is injected (tests,
    the bench's tracing-off arm)."""

    # racecheck guarded-field registry: solves commit from whatever thread
    # ran them while /debug/solves reads from HTTP handler threads
    GUARDED_FIELDS = {"_ring": "_lock", "_windows": "_lock", "dropped": "_lock", "seq": "_lock"}

    def __init__(self, capacity: int = 256, enabled: bool | None = None):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self.capacity = int(capacity)
        self._ring: RingBuffer[SolveTrace] = RingBuffer(self.capacity)
        self._windows: dict[tuple[str, str], RollingQuantiles] = {}
        self.dropped = 0
        self.seq = 0
        self._lock = make_lock("trace")

    # -- lifecycle -----------------------------------------------------------
    def begin(self, n_pods: int = 0) -> SolveTrace:
        with self._lock:
            self.seq += 1
            seq = self.seq
        if self.enabled:
            _install_gc_hook()
        tr = SolveTrace(seq=seq, enabled=self.enabled, n_pods=n_pods)
        _tls.trace = tr
        return tr

    @contextmanager
    def flight(self, n_pods: int = 0, mode: str = "", backend: str = "", registry=None):
        """One flight record: begin a trace (with the recompile sentinel's
        snapshot when enabled), yield it, and commit it with the sentinel's
        delta into `registry` however the block exits."""
        trace = self.begin(n_pods=n_pods)
        trace.mode = mode
        trace.backend = backend
        if trace.enabled:
            trace.jit_before = _SENTINEL.snapshot()
        try:
            yield trace
        finally:
            if trace.enabled:
                trace.recompiles = _SENTINEL.delta(trace.jit_before)
            self.commit(trace, registry=registry)

    def commit(self, trace: SolveTrace, registry=None) -> None:
        if getattr(_tls, "trace", None) is trace:
            _tls.trace = None
        trace.duration = time.perf_counter() - trace.t0
        if not trace.enabled:
            return
        mode = trace.mode or "none"
        with self._lock:
            if len(self._ring) >= self.capacity:
                self.dropped += 1
                if registry is not None:
                    from ..metrics import SOLVER_TRACE_DROPPED_TOTAL

                    registry.counter(
                        SOLVER_TRACE_DROPPED_TOTAL, "SolveTraces evicted from the bounded ring", ()
                    ).inc()
            self._ring.insert(trace)
            changed = [("total", trace.duration), *trace.phase_totals.items()]
            for phase, dt in changed:
                win = self._windows.get((mode, phase))
                if win is None:
                    win = self._windows[(mode, phase)] = RollingQuantiles(self.capacity)
                win.append(dt)
        if registry is not None:
            self._publish(registry, mode, [p for p, _ in changed], trace.recompiles)

    def _publish(self, registry, mode: str, phases: list[str], recompiles: dict[str, int]) -> None:
        from ..metrics import SOLVER_RECOMPILE_TOTAL, SOLVER_SOLVE_QUANTILE_SECONDS

        if recompiles:
            c = registry.counter(SOLVER_RECOMPILE_TOTAL, "JIT recompiles by solver entry point", ("fn",))
            for fn, n in sorted(recompiles.items()):
                c.inc(n, fn=fn)  # solverlint: ok(metric-label-cardinality): fn is always a label from the static JIT_WATCHLIST registry — enum-bounded by construction
        g = registry.gauge(
            SOLVER_SOLVE_QUANTILE_SECONDS,
            "Rolling solve-latency quantiles over the trace ring, per (mode, phase)",
            ("mode", "phase", "quantile"),
        )
        for phase in phases:
            with self._lock:
                win = self._windows.get((mode, phase))
                samples = win.snapshot() if win is not None else []
            if not samples:
                continue
            for qn in ("p50", "p90", "p99"):
                g.set(quantile(samples, _QUANTILE_POINTS[qn], assume_sorted=True), mode=mode, phase=phase, quantile=qn)  # solverlint: ok(metric-label-cardinality): mode is the solver's exit-path enum and phase the span-name enum — both bounded by construction

    # -- reading -------------------------------------------------------------
    def traces(self) -> list[SolveTrace]:
        with self._lock:
            return self._ring.items()

    def last(self) -> SolveTrace | None:
        items = self.traces()
        return items[-1] if items else None

    def stats(self) -> dict[str, dict[str, float]]:
        """{"<mode>/<phase>": {n, p50, p90, p99}} over the rolling windows."""
        with self._lock:
            wins = dict(self._windows)
        out: dict[str, dict[str, float]] = {}
        for (mode, phase), win in sorted(wins.items()):
            samples = win.snapshot()
            out[f"{mode}/{phase}"] = {
                "n": len(samples),
                **{qn: quantile(samples, _QUANTILE_POINTS[qn], assume_sorted=True) for qn in QUANTILE_NAMES},
            }
        return out

    def dump(self, limit: int | None = None) -> dict:
        """The /debug/solves payload: ring content (oldest first), rolling
        stats, and recorder health. `limit` keeps only the newest `limit`
        solves — 0 (or negative) means none, None means all."""
        traces = self.traces()
        if limit is not None:
            traces = traces[-limit:] if limit > 0 else []
        with self._lock:  # dump runs on HTTP handler threads
            recorded, dropped = self.seq, self.dropped
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "recorded": recorded,
            "dropped": dropped,
            "stats": self.stats(),
            "solves": [t.to_dict() for t in traces],
        }


_DEFAULT = TraceRecorder()


def default_recorder() -> TraceRecorder:
    return _DEFAULT
