"""Offline solvetrace/podtrace exporter CLI.

    python -m karpenter_tpu_torch.obs dump.jsonl --out solves.trace.json
    curl :8080/debug/solves | python -m karpenter_tpu_torch.obs - --out solves.trace.json
    curl :8080/debug/events | python -m karpenter_tpu_torch.obs - --events --out events.trace.json
    python -m karpenter_tpu_torch.obs dump.jsonl --format jsonl   # normalize a dump

Input is either JSONL (one SolveTrace dict per line — the bench/exporter
format) or a whole `/debug/solves` dump; with `--events`, a podtrace
`/debug/events` dump or EventRecord JSONL instead. Output is Chrome/
Perfetto trace_event JSON (default) ready for chrome://tracing or
ui.perfetto.dev — event mode renders the watch-delivery / serve-loop /
prestage-worker tracks with cross-thread flow arrows — or normalized
JSONL."""

from __future__ import annotations

import argparse
import json
import sys

from .export import (
    events_to_jsonl,
    events_to_trace_events,
    parse_dump,
    parse_event_dump,
    to_jsonl,
    to_trace_events,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch.obs", description=__doc__)
    parser.add_argument("input", help="trace dump: a JSONL file, a /debug/solves JSON file, or '-' for stdin")
    parser.add_argument("--out", default="-", help="output path ('-' = stdout)")
    parser.add_argument("--format", choices=("perfetto", "jsonl"), default="perfetto")
    parser.add_argument(
        "--events",
        action="store_true",
        help="input is a podtrace dump (/debug/events payload or EventRecord JSONL): "
        "render the event-lifecycle tracks with cross-thread flow arrows instead of solve traces",
    )
    args = parser.parse_args(argv)

    if args.input == "-":
        text = sys.stdin.read()
    else:
        try:
            with open(args.input) as f:
                text = f.read()
        except OSError as e:
            print(f"obs: cannot read {args.input}: {e}", file=sys.stderr)
            return 2
    try:
        traces = parse_event_dump(text) if args.events else parse_dump(text)
    except json.JSONDecodeError as e:
        print(f"obs: input is neither JSONL nor a debug dump: {e}", file=sys.stderr)
        return 2
    if not traces:
        print("obs: no traces in input", file=sys.stderr)
        return 1

    if args.events:
        body = events_to_jsonl(traces) if args.format == "jsonl" else json.dumps(events_to_trace_events(traces))
    else:
        body = to_jsonl(traces) if args.format == "jsonl" else json.dumps(to_trace_events(traces))
    if args.out == "-":
        print(body)
    else:
        with open(args.out, "w") as f:
            f.write(body + "\n")
        print(f"obs: wrote {len(traces)} solve(s) to {args.out} ({args.format})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
