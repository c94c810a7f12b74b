#!/usr/bin/env python3
"""Where a multi-node consolidation round over the 5000-node fleet spends its
host time.

Run from the repository root, on the card or (with `--device cpu`, the
kernels' plain versions) on any machine:

    python3 tools/consolidation_profile.py [--device cpu] [--top 15] [--rounds 3]

It builds `chip_smoke.check_consolidation`'s fleet
(`testing/scenarios.build_consolidation_fleet(5000)`, `Provisioner` with
`GPUSolver`, `DisruptionController(Options())`), runs one LP decision
(`MultiNodeConsolidation._lp_option` over every candidate) to warm the
module caches, then:

- times `--rounds` decisions unprofiled, each with the time Python's cyclic
  garbage collector ran inside it (`gc.callbacks`) and its collections by
  generation, beside the round's stage split (`last_round["stages"]`);
- profiles (`cProfile`) one decision and one `DisruptionController.
  reconcile(force=True)` (which starts the command: `queue.start_command`
  taints and marks the candidates through the store).

For each profile it prints the wall ms of the profiled call and the top
functions by own time and by cumulative time.
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


def report(title: str, prof: cProfile.Profile, ms: float, top: int) -> None:
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out)
    stats.sort_stats("tottime").print_stats(top)
    stats.sort_stats("cumulative").print_stats(top)
    print(f"== {title}: {ms:.3f} ms profiled")
    print("\n".join(line for line in out.getvalue().splitlines() if line.strip()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    import torch

    import chip_smoke as cs
    from chip_smoke import GCClock
    from karpenter_tpu_torch.controllers.disruption.methods import MultiNodeConsolidation
    from karpenter_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    fleet, _prov, dc = cs.consolidation_side(dev)
    print(f"fleet built in {time.perf_counter() - t0:.2f} s on {dev}")

    def decision():
        cands = dc.get_candidates()
        dc.ctx.round_candidates = cands
        dc.ctx.node_pool_totals = None
        m = MultiNodeConsolidation(dc.ctx)
        cmd = m._lp_option(cands, fleet.clock.now() + 1e9)
        return m, cmd

    decision()
    for r in range(args.rounds):
        with GCClock() as gcc:
            t1 = time.perf_counter()
            m, cmd = decision()
            ms = (time.perf_counter() - t1) * 1e3
        stages = m.last_round["stages"]
        top = sorted(stages.items(), key=lambda kv: -kv[1])[:6]
        print(f"decision {r}: {ms:.3f} ms, {len(cmd.candidates)} candidates; gc {gcc.ms:.3f} ms "
              f"(collections by generation {gcc.counts}); largest stages ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in top))

    prof = cProfile.Profile()
    t1 = time.perf_counter()
    prof.enable()
    decision()
    prof.disable()
    report("one LP decision (MultiNodeConsolidation._lp_option)", prof, (time.perf_counter() - t1) * 1e3, args.top)

    prof = cProfile.Profile()
    with GCClock() as gcc:
        t1 = time.perf_counter()
        prof.enable()
        dc.reconcile(force=True)
        prof.disable()
        ms = (time.perf_counter() - t1) * 1e3
    print(f"reconcile: gc {gcc.ms:.3f} ms (collections by generation {gcc.counts})")
    report("one disruption pass (DisruptionController.reconcile(force=True))", prof, ms, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
