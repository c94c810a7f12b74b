"""SolveTrace exporters: one-line JSON per trace, and Chrome/Perfetto
`trace_event` JSON for flamegraph-style inspection of a bench run
(chrome://tracing / https://ui.perfetto.dev open the output directly).

Both operate on trace DICTS (`SolveTrace.to_dict()` shape), so they can
consume live recorder content, a `/debug/solves` dump, or a JSONL file a
previous process wrote — the `python -m karpenter_tpu_torch.obs` CLI does the
latter."""

from __future__ import annotations

import json


def _as_dict(trace) -> dict:
    return trace if isinstance(trace, dict) else trace.to_dict()


def to_jsonl(traces) -> str:
    """One compact JSON object per line, one line per solve."""
    return "\n".join(json.dumps(_as_dict(t), sort_keys=True) for t in traces)


def _span_events(span: dict, wall_us: float, pid: int, tid: int, out: list) -> None:
    out.append(
        {
            "name": span["name"],
            "ph": "X",  # complete event: one entry carries start + duration
            "ts": wall_us + span.get("start_s", 0.0) * 1e6,
            "dur": max(span.get("dur_s", 0.0) * 1e6, 0.01),
            "pid": pid,
            "tid": tid,
            "cat": "solve",
            "args": span.get("attrs", {}),
        }
    )
    for child in span.get("children", ()):
        _span_events(child, wall_us, pid, tid, out)


def to_trace_events(traces) -> dict:
    """Chrome trace_event JSON: each solve is one top-level "solve" slice on
    the timeline (tid = solve mode, so modes read as separate tracks), its
    phase spans nested inside; recompiles surface as instant events."""
    events: list = []
    tids: dict[str, int] = {}
    meta: list = []
    for t in traces:
        d = _as_dict(t)
        mode = d.get("mode") or "none"
        tid = tids.get(mode)
        if tid is None:
            tid = tids[mode] = len(tids) + 1
            meta.append(
                {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid, "args": {"name": f"mode:{mode}"}}
            )
        wall_us = d.get("wall_time", 0.0) * 1e6
        events.append(
            {
                "name": f"solve#{d.get('seq', 0)}",
                "ph": "X",
                "ts": wall_us,
                "dur": max(d.get("duration_s", 0.0) * 1e6, 0.01),
                "pid": 1,
                "tid": tid,
                "cat": "solve",
                "args": {
                    "backend": d.get("backend", ""),
                    "n_pods": d.get("n_pods", 0),
                    "cache": d.get("cache", {}),
                    "fallback_families": d.get("fallback_families", []),
                },
            }
        )
        for span in d.get("spans", ()):
            _span_events(span, wall_us, 1, tid, events)
        for fn, n in sorted(d.get("recompiles", {}).items()):
            events.append(
                {
                    "name": f"recompile:{fn}",
                    "ph": "i",
                    "s": "t",
                    "ts": wall_us,
                    "pid": 1,
                    "tid": tid,
                    "cat": "recompile",
                    "args": {"count": n},
                }
            )
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


# podtrace export: the event-lifecycle tracks. Thread ids are a static
# enum — watch delivery, the serve/fleet loop (where dispatch+solve run),
# and the prestage worker — so one event's journey renders as slices on
# THREE tracks joined by flow arrows (ph s/t/f sharing the event's flow id).
EVENT_TRACKS = (("watch-delivery", 1), ("serve-loop", 2), ("prestage-worker", 3))


def _event_dict(rec) -> dict:
    return rec if isinstance(rec, dict) else rec.to_dict()


def events_to_trace_events(events) -> dict:
    """Chrome/Perfetto trace_event JSON for podtrace EventRecords: per event
    a `coalesce` slice on the watch-delivery track, a `solve` (+`decode`
    tail) slice on the serve-loop track, and a `prestage` slice on the
    worker track when the double buffer staged it — with flow arrows
    carrying the event across threads (the cross-thread stamps ARE the
    product: arrival on a watch thread, dispatch on the fleet loop, staging
    on the worker)."""
    meta = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid, "args": {"name": name}}
        for name, tid in EVENT_TRACKS
    ]
    tids = dict(EVENT_TRACKS)
    out: list = []
    for i, rec in enumerate(events):
        d = _event_dict(rec)
        stages = d.get("stages", {})
        wall_us = d.get("wall_arrival", 0.0) * 1e6
        flow_id = i + 1
        label = d.get("name") or d.get("uid", "?")
        args = {
            "uid": d.get("uid", ""),
            "tenant": d.get("tenant", ""),
            "outcome": d.get("outcome", ""),
            "wake_cause": d.get("wake_cause", ""),
            "solve_seq": d.get("solve_seq", 0),
            "staged": d.get("staged", False),
        }
        coalesce_us = max((stages.get("coalesce", 0.0) + stages.get("sched_wait", 0.0)) * 1e6, 0.01)
        out.append(
            {
                "name": f"coalesce:{label}", "ph": "X", "ts": wall_us, "dur": coalesce_us,
                "pid": 1, "tid": tids["watch-delivery"], "cat": "event", "args": args,
            }
        )
        # flow start at the end of the coalescing window (the dispatch)...
        out.append(
            {"name": "event-flow", "ph": "s", "id": flow_id, "ts": wall_us + coalesce_us,
             "pid": 1, "tid": tids["watch-delivery"], "cat": "event"}
        )
        if d.get("staged"):
            out.append(
                {
                    "name": f"prestage:{label}", "ph": "X", "ts": wall_us,
                    "dur": max(stages.get("prestage", 0.0) * 1e6, 0.01),
                    "pid": 1, "tid": tids["prestage-worker"], "cat": "event", "args": args,
                }
            )
            out.append(
                {"name": "event-flow", "ph": "t", "id": flow_id,
                 "ts": wall_us + max(stages.get("prestage", 0.0) * 1e6, 0.01),
                 "pid": 1, "tid": tids["prestage-worker"], "cat": "event"}
            )
        # ... landing on the solve slice on the serve-loop track
        solve_ts = wall_us + coalesce_us
        out.append(
            {
                "name": f"solve:{label}", "ph": "X", "ts": solve_ts,
                "dur": max(stages.get("solve", 0.0) * 1e6, 0.01),
                "pid": 1, "tid": tids["serve-loop"], "cat": "event", "args": args,
            }
        )
        out.append(
            {"name": "event-flow", "ph": "f", "bp": "e", "id": flow_id, "ts": solve_ts,
             "pid": 1, "tid": tids["serve-loop"], "cat": "event"}
        )
        if stages.get("decode", 0.0) > 0.0:
            out.append(
                {
                    "name": f"decode:{label}", "ph": "X",
                    "ts": solve_ts + max(stages.get("solve", 0.0) * 1e6, 0.01),
                    "dur": stages["decode"] * 1e6,
                    "pid": 1, "tid": tids["serve-loop"], "cat": "event", "args": args,
                }
            )
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def events_to_jsonl(events) -> str:
    """One compact JSON object per line, one line per completed event."""
    return "\n".join(json.dumps(_event_dict(e), sort_keys=True) for e in events)


def parse_event_dump(text: str) -> list[dict]:
    """Accept a /debug/events dump (object with "tenants"), a single
    tracer dump (object with "events"), or JSONL of EventRecord dicts."""
    text = text.strip()
    if not text:
        return []
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        obj = None
    if isinstance(obj, dict):
        if "tenants" in obj:
            out: list[dict] = []
            for dump in obj["tenants"].values():
                out.extend(dump.get("events", ()))
            return out
        if "events" in obj:
            return list(obj["events"])
        return [obj]
    if isinstance(obj, list):
        return obj
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def parse_dump(text: str) -> list[dict]:
    """Accept either a /debug/solves dump (object with "solves") or JSONL
    (one trace object per line) and return the trace dicts."""
    text = text.strip()
    if not text:
        return []
    try:  # a single JSON document: a /debug/solves dump, a list, or one trace
        obj = json.loads(text)
    except json.JSONDecodeError:
        obj = None
    if isinstance(obj, dict):
        return list(obj["solves"]) if "solves" in obj else [obj]
    if isinstance(obj, list):
        return obj
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if isinstance(obj, dict) and "solves" in obj:
            out.extend(obj["solves"])
        else:
            out.append(obj)
    return out
