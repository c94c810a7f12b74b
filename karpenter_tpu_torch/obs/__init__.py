"""karpenter_tpu_torch.obs — the solvetrace + podtrace flight recorders.

`trace` holds the span API, SolveTrace, the kernel-library load sentinel,
and the bounded TraceRecorder ring with rolling P50/P90/P99; `podtrace` is
the event-lifecycle recorder (watch-event arrival through coalesce / solve /
bind, with per-stage quantiles and the SLO budget); `export` renders both as
JSONL or Chrome/Perfetto trace_event JSON (`python -m
karpenter_tpu_torch.obs`, `--events` for the podtrace tracks); `stats` is
the one nearest-rank quantile implementation; `detcheck` the dual-run
determinism check and `racecheck` the lock sanitizer. Importing this
package imports no torch."""

from .podtrace import WAKE_CAUSES, EventRecord, PodTracer, SLOBudget
from .podtrace import STAGES as EVENT_STAGES
from .stats import RollingQuantiles, quantile
from .trace import (
    JIT_WATCHLIST,
    RecompileSentinel,
    SolveTrace,
    Span,
    TraceRecorder,
    current_trace,
    default_recorder,
    sentinel,
)

__all__ = [
    "EVENT_STAGES",
    "EventRecord",
    "JIT_WATCHLIST",
    "PodTracer",
    "RecompileSentinel",
    "RollingQuantiles",
    "SLOBudget",
    "SolveTrace",
    "Span",
    "TraceRecorder",
    "WAKE_CAUSES",
    "current_trace",
    "default_recorder",
    "quantile",
    "sentinel",
]
