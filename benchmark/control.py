"""The control of a cell's correctness check: the plain reference put in
the program's place and computed in the precision below the one the
configuration states, judged by the same comparison as a run. It has to
come out not correct; its smallest reading of each number is the upper
reading a limit is set below (PERF.md gives them).

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

prints one JSON line per seed. The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness, manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    harness.prepare_env(harness.ROOT)
    m = manifest.load(harness.ROOT)
    c = manifest.cell(m, harness.ROOT, args.workload)
    mod = manifest.kind(c["traffic"]["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        got = mod.control(c["config"], c["traffic"], seed)
        got = {k: got[k] for k in c["limits"]}
        over = {k: v for k, v in got.items() if v > c["limits"][k]}
        print(json.dumps({"workload": args.workload, "seed": seed, "compared": got, "fails": sorted(over)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
