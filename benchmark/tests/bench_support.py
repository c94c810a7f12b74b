"""Shared by the harness's CPU tests: one cell run on the CPU at a small
size, capturing the result line and the compared numbers."""

from __future__ import annotations

import contextlib
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes of each cell, for the CPU (the kernels' plain versions)
SMALL = {"sched2k.burst": {"config": {"pods": 300}, "traffic": {"warm_solves": 1}}}


def run_cell(workload: str, seed: int = 7, seconds: float = 0.2, trace: int = 0, root: Path = ROOT,
             overrides: dict | None = None) -> tuple[int, dict | None, str]:
    """(exit code, the last stdout line parsed, stderr) of one CPU run."""
    import torch

    from benchmark import harness, manifest

    torch.set_num_threads(1)
    args = harness.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)])
    out, err = io.StringIO(), io.StringIO()
    harness.prepare_env(root)
    with contextlib.redirect_stderr(err):
        rc = harness.run(args, torch.device("cpu"), time.perf_counter(), manifest.load(root), root=root,
                         overrides=SMALL[workload] if overrides is None else overrides, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
