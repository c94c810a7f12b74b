"""A scale-up burst: every pending pod of the snapshot turned into
NodeClaims by a fresh `GPUSolver` (its own encode cache), solves back to
back, as upstream's benchmark builds a new scheduler every iteration. The
process's module-level caches stay warm, as in a long-lived controller.

Traffic parameters: `warm_solves`, the solves of set-up.

`correct` judges two of the window's solves (its first, and one drawn from
the seed) against the reference: the guarantees of `reference/check.py`
and the cost against the reference packer's."""

from __future__ import annotations

import random
import time

from benchmark.inputs import burst
from benchmark.inputs.catalog import instance_types
from benchmark.reference import catalog as ref_catalog
from benchmark.reference import check as ref_check
from benchmark.reference import pack as ref_pack
from benchmark.reference import pods as ref_pods


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device, trace: bool):
        self.config, self.traffic, self.seed, self.device, self.trace = config, traffic, seed, device, trace
        self.kept: list = []
        self.k2_launch = None

    def setup(self, seconds: float) -> None:
        from karpenter_tpu_torch.obs.trace import TraceRecorder

        self.specs = burst.pod_specs(self.config, self.seed)
        self.snap = burst.snapshot(self.specs, instance_types(self.config))
        # the program's default flight recorder (256 traces), or one that holds
        # the whole window for the traced run's spans
        self.recorder = TraceRecorder(capacity=1 << 14) if self.trace else TraceRecorder()
        for i in range(self.traffic["warm_solves"]):
            if self.trace and i == self.traffic["warm_solves"] - 1:
                self.k2_launch = self._k2_cost_of_a_solve()
            else:
                self._solve()

    def _solve(self):
        import torch

        from karpenter_tpu_torch.solver.gpu import GPUSolver

        results = GPUSolver(device=self.device, stage_times=self.trace, recorder=self.recorder).solve(self.snap)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return results

    def _k2_cost_of_a_solve(self):
        """One warm solve with K2's launches counted (`roofline.k2_cost`):
        the bytes and operations of one launch, on average. Every solve packs
        the same snapshot, so the traced window's launches each do this work."""
        from benchmark.roofline import k2_cost
        from karpenter_tpu_torch.kernels import pack_scan as mod

        real, seen = mod.pack_scan, []

        def counted(t, items, compat, key, *, n_slots, init_state=None):
            takes, left, state = real(t, items, compat, key, n_slots=n_slots, init_state=init_state)
            seen.append(k2_cost(t, items, compat, key, n_slots, state, takes, left))
            return takes, left, state

        mod.pack_scan = counted
        try:
            self._solve()
        finally:
            mod.pack_scan = real
        return (sum(b for b, _ in seen) / len(seen), sum(o for _, o in seen) / len(seen)) if seen else None

    def window(self, seconds: float) -> dict:
        pick = random.Random(self.seed)
        mark = self.recorder.seq
        n = placed = failed = 0
        t0 = time.perf_counter()
        while True:
            results = self._solve()
            n += 1
            bad = len(results.pod_errors)
            placed += len(self.specs) - bad
            failed += bad
            # the window's first solve, and one drawn uniformly from the rest (a reservoir of one)
            if n == 1:
                self.kept = [results, None]
            elif pick.random() < 1.0 / (n - 1):
                self.kept[1] = results
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.n_solves = n
        self.traces = [t for t in self.recorder.traces() if t.seq > mark]
        return {"metrics": {"pods_per_s": placed / wall}, "attempted": n * len(self.specs), "failed": failed}

    def layer_context(self) -> dict:
        from benchmark.device import trace_spans

        return {"cell": "burst", "solves": self.n_solves,
                "stages": [{k: v * 1e3 for k, v in t.phase_totals.items()} for t in self.traces],
                "k2_launch": self.k2_launch, "spans": trace_spans(self.traces)}

    def release(self) -> None:
        self.kept = [burst.placement(r) for r in self.kept if r is not None]
        self.snap = self.recorder = self.traces = None

    def check(self) -> dict:
        cat = ref_catalog.catalog(self.config)
        pods = ref_pods.arrays(self.specs, self.config["mix"]["label_values"])
        ref = ref_pack.pack(cat, pods)
        worst: dict = {}
        for claims, unplaced in self.kept:
            for k, v in ref_check.check(cat, pods, claims, unplaced, ref).items():
                worst[k] = max(worst.get(k, v), v)
        return worst


# the precision below the configuration's (milli-cores and bytes): whole
# cores and whole GiB, rounded down, as a packer that quantises requests would
CONTROL_QUANTUM = (1000, 1 << 30, 1)


def control(config: dict, traffic: dict, seed: int) -> dict:
    """The reference packer, with requests in the lower precision, in the
    program's place: its placement judged as a run judges the program's."""
    specs = burst.pod_specs(config, seed)
    cat = ref_catalog.catalog(config)
    pods = ref_pods.arrays(specs, config["mix"]["label_values"])
    ref = ref_pack.pack(cat, pods)
    low = ref_pack.pack(cat, pods, quantum=CONTROL_QUANTUM)
    claims = [{"pods": [specs[i]["key"] for i in c], "types": t,
               "zones": [z for z, on in zip(cat.zones, zm) if on]}
              for c, t, zm in zip(low["claims"], low["types"], low["zones"])]
    return ref_check.check(cat, pods, claims, [specs[i]["key"] for i in low["unplaced"]], ref)
