"""One run of one cell: `python3 benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`.

The run loads the program, builds the cell's inputs from the seed and warms
up every shape the traffic uses (set-up), measures for `--seconds` (with
`--trace 1` under the profiler, for the per-layer metrics), reads the
device's memory peak, frees the program's state, judges what the timed
calls returned against the plain reference, checks that nothing of JAX or
of the JAX package was loaded, and prints one JSON line last on stdout.
The numbers compared, each beside its limit, are the last lines on stderr
and the last key of that line."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from . import manifest
from .device import TracedWindow

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")
# the host threads of the controller's process (PyTorch's intra-op pool and
# the BLAS pools): the solve's host work is one Python thread, and one
# process on one fixed core keeps runs steady on a host whose cores other
# work shares
HOST_THREADS = 1


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of loaded modules that the benchmark's process must
    not hold, compared whole (the port's name begins with the JAX
    package's)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def pin_to_one_core() -> int:
    """Bind this process, and every thread it starts from now on, to the
    highest-numbered core it may use: a solve's host work no longer moves
    between cores, which spread a solve's time by some 25% where one core
    held it within 1% (PERF.md). Returns the core."""
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core


def prepare_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, and
    the program's switches at their defaults (a traffic mix may set some)."""
    for k in [k for k in os.environ if k.startswith("KARPENTER_")]:
        del os.environ[k]
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = str(HOST_THREADS)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, start: float | None = None) -> int:
    start = time.perf_counter() if start is None else start
    args = parse(argv)
    prepare_env(ROOT)
    pin_to_one_core()
    import torch

    m = manifest.load(ROOT)
    chips = next((w["chips"] for w in m["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(HOST_THREADS)
    return run(args, torch.device("cuda", 0), start, m)


def run(args, device, start: float, m: dict | None = None, root: Path = ROOT, overrides: dict | None = None,
        out=None) -> int:
    """The run proper; `device` may be the CPU (the harness's own tests),
    `overrides` replaces configuration or traffic values (their small
    sizes). Returns the exit code; the result line goes to `out`."""
    import torch

    out = sys.stdout if out is None else out
    m = manifest.load(root) if m is None else m
    bad = manifest.problems(m, root)
    if bad:
        print("BENCHMARK.json: " + "; ".join(bad), file=sys.stderr)
        return 2
    c = manifest.cell(m, root, args.workload)
    for part in ("config", "traffic"):
        c[part].update((overrides or {}).get(part, {}))
    os.environ.update(c["traffic"].get("env", {}))
    job = manifest.kind(c["traffic"]["kind"]).Run(c["config"], c["traffic"], args.seed, device,
                                                 trace=bool(args.trace))
    job.setup(args.seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # every window starts from the same collector state: what set-up left
    # behind is collected here, not at a moment that differs run to run
    gc.collect()
    setup_s = time.perf_counter() - start
    with TracedWindow(bool(args.trace) and device.type == "cuda") as win:
        res = job.window(args.seconds)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    metrics, dev = {}, {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                        "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if args.trace:
        ctx = job.layer_context()
        if win.prof is not None:
            summary = win.summary(ctx.get("spans", []))
            ctx.update(busy_s=summary["busy_s"], window_s=summary["window_s"], kernels=summary["kernels"],
                       launches=summary["launches"])
            dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            breakdown = summary["breakdown"]
        for x in c["per_layer"]:
            v = manifest.reader(root, x["name"])(ctx)
            if v is not None:
                metrics[x["name"]] = {"value": float(v), "unit": x["unit"]}
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        for x in c["end_to_end"]:
            metrics[x["name"]] = {"value": float(values[x["name"]]), "unit": x["unit"]}
    job.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = job.check()
    compared = {k: {"value": float(checks.get(k, math.inf)), "limit": float(lim)} for k, lim in c["limits"].items()}
    correct = all(x["value"] <= x["limit"] for x in compared.values())
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 4
    line = {"correct": correct, "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["card"] = power_limit() if device.type == "cuda" else "cpu"
    line["compared"] = compared
    for k, x in compared.items():
        print(f"compared {k} {x['value']!r} limit {x['limit']!r}", file=sys.stderr)
    print(json.dumps(line), file=out, flush=True)
    return 0
