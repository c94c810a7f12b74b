#!/usr/bin/env python3
"""Where a provisioning pass over the hybrid headline spends its host time.

Run from the repository root, on the card or (with `--device cpu`, the
kernels' plain versions) on any machine:

    python3 tools/provision_profile.py [--device cpu] [--top 15]

It builds `chip_smoke.check_provision`'s store (the hybrid headline's
nodepool and its 5000 pods created pending, `FakeCloudProvider(
instance_types_assorted(100))`, a `FakeClock`), runs one pass to warm the
module caches, then on a fresh store and solver profiles (`cProfile`):

- `Provisioner.get_pending_pods` (reading, validating and cloning the
  pending pods);
- the residual host FFD (`ffd.solve_residual`) of the pass's hybrid solve;
- the residual host FFD of `GPUSolver.solve` on the same snapshot with no
  pod in its store (`chip_smoke.check_hybrid`'s context).

For each it prints the wall ms of the profiled call and of the same call
unprofiled, and the top functions by own time and by cumulative time.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def fresh(dev, with_pods: bool):
    import chip_smoke as cs

    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types_assorted
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    snap, _added, _one = cs.seeded_snapshot(fallback_frac=cs.HYBRID_FALLBACK_FRAC)
    if with_pods:
        cs.pending_store(snap)
    reset_bucket_highwater()
    gpu = GPUSolver(dev, stage_times=True)
    cloud = FakeCloudProvider(instance_types_assorted(cs.SNAPSHOT_SHAPE[1]))
    return snap, gpu, Provisioner(snap.store, snap.cluster, cloud, snap.clock, solver=gpu)


def report(title: str, prof: cProfile.Profile, ms: float, plain_ms: float, top: int) -> None:
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out)
    stats.sort_stats("tottime").print_stats(top)
    stats.sort_stats("cumulative").print_stats(top)
    print(f"== {title}: {ms:.3f} ms profiled, {plain_ms:.3f} ms unprofiled")
    print("\n".join(line for line in out.getvalue().splitlines() if line.strip()))


def profile_residual(run, top: int, title: str) -> None:
    """Run `run()` twice (unprofiled, then profiled), timing and profiling
    each call of the solver's residual host FFD."""
    import random

    from karpenter_tpu_torch.solver import gpu as gpu_mod

    real = gpu_mod.solve_residual
    seen: dict = {}

    def timed(*args, **kwargs):
        prof = seen.get("prof")
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        try:
            return real(*args, **kwargs)
        finally:
            if prof is not None:
                prof.disable()
            seen.setdefault("ms", []).append((time.perf_counter() - t0) * 1e3)

    gpu_mod.solve_residual = timed
    try:
        random.seed(0)
        run(False)
        plain = seen.pop("ms")
        seen["prof"] = cProfile.Profile()
        random.seed(0)
        run(True)
    finally:
        gpu_mod.solve_residual = real
    if len(plain) != 1 or len(seen["ms"]) != 1:
        raise SystemExit(f"{title}: {len(plain)} / {len(seen['ms'])} residual calls, not one each")
    report(title, seen["prof"], seen["ms"][0], plain[0], top)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--top", type=int, default=15, help="functions listed per ordering")
    args = ap.parse_args()
    # the fixtures' reference outputs were made with plain shape bucketing
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    import torch

    from karpenter_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              stdout=subprocess.PIPE, text=True).stdout.strip()
        print(f"card: {card}")
    import platform

    print(f"host: {platform.processor() or platform.machine()}, {os.cpu_count()} cores, torch {torch.__version__}, "
          f"device {dev}")

    _snap, _gpu, prov = fresh(dev, True)
    prov.reconcile(force=True)  # warm the module caches
    sync()

    _snap, _gpu, prov = fresh(dev, True)
    t0 = time.perf_counter()
    pods = prov.get_pending_pods()
    plain_ms = (time.perf_counter() - t0) * 1e3
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    again = prov.get_pending_pods()
    prof.disable()
    ms = (time.perf_counter() - t0) * 1e3
    assert len(again) == len(pods)
    report(f"get_pending_pods ({len(pods)} pending pods)", prof, ms, plain_ms, args.top)

    def pass_run(_profiled: bool) -> None:
        _snap, gpu, prov = fresh(dev, True)
        prov.reconcile(force=True)
        sync()
        assert gpu.last_solve_mode == "hybrid", gpu.last_solve_mode

    profile_residual(pass_run, args.top, "residual FFD in a provisioning pass (5000 pending pods in the store)")

    def solve_run(_profiled: bool) -> None:
        snap, gpu, _prov = fresh(dev, False)
        gpu.solve(snap)
        sync()
        assert gpu.last_solve_mode == "hybrid", gpu.last_solve_mode

    profile_residual(solve_run, args.top, "residual FFD in GPUSolver.solve (no pod in the store)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
