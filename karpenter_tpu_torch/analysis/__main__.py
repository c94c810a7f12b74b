"""CLI gate: `python -m karpenter_tpu_torch.analysis`.

Exit codes: 0 clean, 1 findings, 2 broken analyzer (config error, rule
registry shrank, globs matching nothing, or --self-test failure) — a broken
gate must fail loudly, never pass vacuously.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from .config import ConfigError, load_config
from .core import repo_root, run_analysis, run_self_test
from .rules import RULES


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch.analysis", description=__doc__)
    parser.add_argument("--self-test", action="store_true", help="verify every rule detects its seeded violation")
    parser.add_argument("--root", type=Path, default=None, help="repo root (default: auto-detected)")
    parser.add_argument("--rule", action="append", dest="rules", help="run only this rule (repeatable)")
    parser.add_argument("--jobs", type=int, default=1, help="run rules concurrently on N threads (parsed modules are shared either way)")
    parser.add_argument("--format", choices=("text", "json"), default="text", help="finding output format (json: file/line/rule/message/pragma-status, for CI diffing)")
    parser.add_argument("paths", nargs="*", type=Path, help="restrict the scan to these files")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    try:
        root = args.root or repo_root()
        config = load_config(root)
        if args.self_test:
            failures = run_self_test(config)
            if failures:
                for f in failures:
                    print(f"self-test FAILED: {f}", file=sys.stderr)
                return 2
            print(f"solverlint self-test: {len(RULES)} rules healthy ({time.perf_counter() - t0:.2f}s)")
            return 0
        if len(RULES) < 15:
            print(f"solverlint: rule registry shrank to {len(RULES)} rules", file=sys.stderr)
            return 2
        for p in args.paths:
            if not p.is_file():
                # an unreadable operand is an operator error (exit 2), never
                # "findings" (exit 1) or a raw traceback
                print(f"solverlint: not a readable file: {p}", file=sys.stderr)
                return 2
        findings = run_analysis(root=root, config=config, rules=args.rules, paths=args.paths or None, jobs=args.jobs)
    except ConfigError as e:
        print(f"solverlint: broken configuration: {e}", file=sys.stderr)
        return 2
    ordered = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    if args.format == "json":
        import json

        # machine-readable surface for CI and the bench lint_wall scenario:
        # finding counts diff cleanly across runs instead of being grepped
        # out of text. pragma_status distinguishes the pragma machinery's own
        # findings from ordinary unsuppressed ones (suppressed findings are
        # never emitted at all).
        status = {"solverlint-pragma": "malformed", "stale-pragma": "stale"}
        payload = {
            "rules": sorted(RULES),
            "count": len(ordered),
            "elapsed_s": round(time.perf_counter() - t0, 3),
            "findings": [
                {
                    "file": f.path,
                    "line": f.line,
                    "rule": f.rule,
                    "message": f.message,
                    "pragma_status": status.get(f.rule, "unsuppressed"),
                }
                for f in ordered
            ],
        }
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 1 if ordered else 0
    if ordered:
        for f in ordered:
            print(f)
        print(f"\nsolverlint: {len(ordered)} finding(s) ({time.perf_counter() - t0:.2f}s)", file=sys.stderr)
        return 1
    print(f"solverlint: clean ({len(RULES)} rules, {time.perf_counter() - t0:.2f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
