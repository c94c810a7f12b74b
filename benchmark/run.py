"""Run one benchmark cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `benchmark/` and
the program. See `benchmark/harness.py`."""

import os
import sys
import time

_START = time.perf_counter()


def _hash_seed(argv) -> str | None:
    """The interpreter's string-hash seed for a run: its `--seed`, so that
    the seed fixes every set's and dict's order, and with it the work."""
    for flag, value in zip(argv, argv[1:]):
        if flag == "--seed" and value.lstrip("-").isdigit():
            return str(int(value) % (1 << 32))
    return None


if __name__ == "__main__":
    from pathlib import Path

    want = _hash_seed(sys.argv[1:])
    if want is not None and os.environ.get("PYTHONHASHSEED") != want:
        os.environ["PYTHONHASHSEED"] = want
        os.execv(sys.executable, [sys.executable, *sys.argv])
    # the checkout's root in place of this folder: the harness imports as `benchmark`
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from benchmark.harness import main

    sys.exit(main(start=_START))
