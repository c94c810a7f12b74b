#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`karpenter_tpu_torch`) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It prints the card's name and power limit, builds the eight CUDA kernels
(and K2's slot-sharded form) from `karpenter_tpu_torch/kernels/csrc/`, and
for every fixture in `karpenter_tpu_torch/fixtures/` holds each pack kernel
against its plain
PyTorch version on the card (`torch.equal`: integer, bool and identically
computed f32 outputs) and the pack's flat output and final carry against the
JAX reference stored in the fixture, and K1 on its own cases (`K1_CASES`:
negative label ids, ids past the last word, forced keys of -1, 0, K - 1
and K, out-of-range taint classes, zero requests and pad rows, K = 40,
no items, 70000 items, a ragged row axis, a K whose rows go to the global
scratch), key bits included. It then drives the full path,
`GPUSolver().solve_encoded`, on the headline problem (5000 pods x 100
instance types) and its required-affinity variant with every launch count
set to 0 just before and read just after, and requires 0 validation errors,
every pod placed and the stored JAX assignment; and the dense pack
(`greedy_pack_grouped`) against its plain version and the JAX takes.

Then the snapshot phase (`check_snapshot`): the port builds the headline
`SolverSnapshot` itself (`testing/scenarios.build_snapshot(5000, 100)`, pod
names counted from pod-1 and every uid drawn from a generator seeded with
`SNAPSHOT_SEED`, the fixture's seed), encodes it with its own encoder
and requires every numpy array and name list of the encoding to equal
`fixtures/snapshot/headline_5000x100_seeded.npz` (written by the JAX package
from the same seeded build), and solves it with `GPUSolver().solve_encoded`,
the counts set to 0 just before and read just after: K1-K3 launched once
each, K4 not, the JAX assignment and open count. It then removes 600 pods,
appends 800 made by the builder, encodes through its `EncodeCache` (the
delta encode, equal to the fixture's) and solves from the resident carry:
K4 and K1-K3 launched once each, the JAX delta step's assignment and open
count. The inputs of each pack (K1 -> K2 -> K3) and recredit (K4) the two
solves made are kept, and each kernel is run again on them and held
against its plain version and against what the solve got, bit for bit
(K2 with every carry leaf). It times the full encode, the delta encode and
snapshot to placement (encode, the copy into the device path's problem,
`solve_encoded`; the solver is built before the window, as in the main
path's timing), median of 5 warm runs each.

Then the solve phase (`check_solve`): `GPUSolver().solve(snap)`, snapshot
to NodeClaims, over the seeded headline's `SOLVE_STEPS`: a full solve, an
identical resubmit, the -600 +800 delta and one more pod appended, the
counts set to 0 just before each step and read just after. Each step's
canonical `Results` (claims with their instance types and requirements,
pods on existing nodes, pod errors), mode, backend and delta-reject reason
must equal the JAX reference's
(`fixtures/snapshot/headline_5000x100_seeded_results.json`), with K1-K3
launched once on step 0, nothing on the resubmit, K4 and K1-K3 on the
delta, K1-K3 on the last step; each pack and recredit is run again on its
kept inputs against its plain version. No step may fall back to the host.
It times, median of 5 warm runs (host clock, device synchronised after
each stage), a cold solve on a fresh solver, the resubmit, the delta and
the warm one-pod delta, decode split out.

Then the flight-record phase (`check_observability`) over the same
snapshot and steps: the chain again through
`GPUSolver(registry=make_registry(), recorder=TraceRecorder())`, each
step's Results equal to the reference's, its launches as before, its trace
with the step's mode, backend "gpu", the spans `encode` and `pack` (with
`validate` on a full pack and `decode` inside), no kernel-library load
after the first solve, and the solve counters and rolling quantile gauges
in the exposition text; the same chain with `TraceRecorder(enabled=False)`
gives the same Results. It prints the tracing overhead (median of 5 warm
solves, traced against untraced, alternated: a fresh solver's full solve
and a warm resubmit) beside the card's name and power limit. Then the
recovery ladder: a fault at "solve" on a warm delta (the resubmit) is
served through the quarantined full re-encode (noted on the trace, K1-K3
launched again, the reference's Results), the next solve is a delta again,
and after `quarantine_caches()` a full one; `kernels.build.check` failing
once, and `kernels.build.require` refusing a tensor once, each raise
`KernelError` out of the solve, never a host answer. Then the
determinism check: the chain recorded with `KARPENTER_SOLVER_DETCHECK=1`
and replayed by `check_determinism()` in a child process on the card,
with its digests, modes and wall time printed. The hybrid phase prints the
cold hybrid solve's `explain()`, and the consolidation phase runs the LP
decision once more with a registry and an enabled recorder: the round's
trace (spans `encode_candidates`, `lp_repack`, `round`, `validate`), its
counters equal to the reference's (stored beside the decision in
`fixtures/consolidation/fleet_5000_lp_command.json`) and its breakdown
read from the spans.

Then the hybrid phase (`check_hybrid`): the same recipe with 5% of the
pods carrying a preferred pod affinity (`bench.py`'s `bench_hybrid_path`
shape; pod-local fallback reasons), solved by `GPUSolver().solve` over
`HYBRID_STEPS`: a cold hybrid solve (the in-window majority masked out of
the encoding and packed on the card, the flagged residual on the host
FFD), an identical resubmit and one pod appended (hybrid-delta from the
masked carry), 600 pods removed (the reference's masked delta re-credits
them, fails validation and the cold hybrid packs again), every flagged pod
removed (a pure delta from the masked carry), the counts set to 0 just
before each step and read just after. Each step's canonical `Results`,
mode, backend, fallback and delta-reject reasons must equal the JAX
reference's (`fixtures/snapshot/headline_5000x100_hybrid_results.json`),
with the launches of `HYBRID_LAUNCHES`, each pack and recredit held to its
plain version on its kept inputs; no step may fall back. Then the
provisioner phase (`check_provision`): a store holding that headline's
pods pending, one `Provisioner(..., solver=GPUSolver()).reconcile(force=True)`:
its `Results`, mode, backend and the NodeClaims created in the store equal
the JAX reference's pass, K1-K3 launched once. They time, median of 5
warm runs: a cold hybrid solve by stage (encode, mask_encode, the masked
pack, decode, residual) and the warm one-pod hybrid-delta; median of 3:
one provisioning pass on a fresh store and solver.

Then the wide phase (`check_wide`): the same hybrid recipe over 1000
instance types (`WIDE_SHAPE`; the nodepool's amd64/linux requirement
leaves 250, past the 200 rows from which the residual FFD answers its
per-type requirement checks through the C++ requirement table,
`karpenter_tpu_torch/native/`), solved by `GPUSolver().solve` over
`WIDE_STEPS`: a cold hybrid solve, an identical resubmit and one pod
appended, the launch counts and the table's counts set to 0 just before
each step and read just after. Each step's canonical `Results`, mode,
backend and reasons must equal the JAX reference's
(`fixtures/snapshot/headline_5000x1000_hybrid_results.json`), with K1-K3
launched as the step's mode says (each pack held to its plain version on
its kept inputs) and the table built and queried on the cold solve. It
times, median of 5 warm runs, the cold hybrid solve by stage (the
residual's `ffd.*` spans and the table's build and filter time split out)
and `FFDSolver().solve` over the same snapshot with the table and with the
Python algebra (the threshold patched above 1000 rows), alternated, both
arms' Results equal: host times, printed beside the card's name and power
limit.

Then the DRA phase (`check_dra`): the seeded headline made into its DRA
variant (`testing/scenarios.add_dra`: 256 of its plain pods hold a device
claim from a `ResourceClaimTemplate`, 192 one GPU and 64 two GPUs of one
NVLink island under a matchAttribute constraint; a `DeviceClass` selects
the GPUs by a CEL expression; 16 of the 100 instance types carry 8 template
GPUs, one of them drawing on a partitionable counter set), solved cold
(D0) and with one plain pod appended (D1) by `GPUSolver().solve`, then one
`Provisioner.reconcile(force=True)` with the DynamicResources gate on over
a store holding its pods pending (D2), the counts set to 0 just before each
step and read just after. Each step's canonical `Results`, mode, backend,
fallback reasons, the residual allocator's committed allocations and claim
metadata and D2's NodeClaims must equal the JAX reference's
(`fixtures/snapshot/headline_5000x100_dra_results.json`), with K1-K3
launched once each and each pack held to its plain version on its kept
inputs. It times a cold DRA solve by stage, the allocator's share of the
residual FFD split out, median of 3 warm runs (5 under `--only dra`).

Then the consolidation phase (`check_consolidation`): the port builds the
reference benchmark's 5000-node underutilized fleet itself
(`testing/scenarios.build_consolidation_fleet(5000)`, on a `FakeClock`) and
wires `Store`, `Cluster`, `Provisioner(solver=GPUSolver())` and
`DisruptionController(Options())` directly. One LP decision,
`MultiNodeConsolidation._lp_option` over every candidate, the counts set to
0 just before and read just after: its `Command` (candidates, replacement,
the simulation's `Results`) and masked and scratch probe counts must equal
the JAX reference's
(`fixtures/consolidation/fleet_5000_lp_command.json`), with K5 and K6
launched once and K1-K3 once per masked probe; the inputs of each are kept
and each kernel is run again on them against its plain version. It times
the decision, median of 3 warm rounds, by stage (candidates, the encoder,
the tensors, K5, rounding, K6, the ladder, and the exact validation split
into the round-base encode, `sim_mask_encode` and `solve_prepared`'s own
stages), with the time Python's cyclic collector ran within each round.
Then one `DisruptionController.reconcile(force=True)`, timed: the
command it starts (after the Validator's 15 s wait on the fake clock and
its from-scratch re-simulation), the disrupted taints and the NodeClaims in
the store (the replacement among them) must equal the reference's, with K5
and K6 once and K1-K3 once per probe and once for the re-simulation.

Then the consolidation arms' phase (`check_consolidate_arms`): the
bench's consolidation fleet at `ARMS_NODES` (128) nodes, every node
budget-eligible, so the annealed search's 100-candidate window is full and
K7 runs at Np = 128. For each `KARPENTER_CONSOLIDATE_LP` arm ("1", the
relaxed LP; "0", the binary search alone; "anneal", the annealed search) a
fresh fleet and one `DisruptionController.reconcile(force=True)` through
the exact Validator, the counts set to 0 just before and read just after:
the commands it starts, the disrupted taints, the NodeClaims and the clock
must equal the JAX reference's (`fixtures/consolidation/fleet_128_arms.json`,
written by `tests/test_torch_switches.py --write`), with K5 and K6 once on
"1", none of K5-K7 on "0", and K7's pre-pass and chains once each and no K5
or K6 on "anneal"; K7's inputs in that pass are kept and K7 is held to its
plain version on them, bit for bit. Each arm's pass is timed again on a
fresh fleet, with every arm warm. Then the "1" arm again, and the seeded headline's
`SOLVE_STEPS`, with the host switches at the reference's exact arms
(`EXACT_ARMS`: the unbatched FFD, the legacy encode, the decode without
its memo, the round without its shared scheduler seed): the same commands
and Results as the default arms'. `python3 chip_smoke.py --only arms` runs
just this phase after the build.

Then the meshed phase (`check_sharded`): the slot-sharded K2
(`pack_scan_sharded.cu`, a block per shard) in both its forms: the cluster
form (`pack_scan_cluster`: the shards one thread-block cluster, the three
exchanges through distributed shared memory) and the grid form
(`pack_scan_sharded`: one cooperative launch, the exchanges through global
memory). Both against the plain multi-shard arm on `tests/test_sharded.py`'s
zone-spread + anti-affinity snapshot at 3 and 5 shards (slot axes padded),
against K2 at the headline and both existing fleets at 2, 4 and 8 shards
and on every small fixture and the caps problems at 3 and 5, with the same
exchange counts; the grid form at 33 and 64 shards (past one warp's lanes:
`MESH_WIDE_SIZES`, past the largest cluster) against K2 at the headline
and both fleets; in every output and carry leaf, bit for bit, with K1 per
shard (`sharded_feasibility`) against K1. The chooser must pick the cluster
form up to 8 shards and the grid form at 33 and 64. Then
`GPUSolver(mesh=make_mesh([dev] * 4)).solve(snap)` over the seeded
headline's `SOLVE_STEPS` and the hybrid headline's `HYBRID_STEPS`, the
counts set to 0 just before each step and read just after: the
reference's Results, mode and reasons at every step, K1 four times and the
cluster form once on a full pack, the delta steps on the single-device
path over the gathered carry; and the seeded headline's first step on a
mesh of 33 shards (K1 33 times, the grid form once). `anneal_sharded` (K7
per shard) against K7 on one device over the same keys,
`sharded_compat_matrix` (K1 per shard) against K1 over the headline's
pods. It times both forms at the headline per shard count (2, 4, 8; the
grid form at 33 on a padded slot axis and 64, the cluster form at the
largest cluster the card places), K2 in the same run before and after and
the plain arm once, and counts the exchanges.

Then the operator phase (`check_operator`): the seeded headline's nodepool
and 100 instance types in the operator's `Environment(Options())` with no
device (its `GPUSolver` on the card), the 5000 pods created pending, then a
2 s clock step and `tick(provision_force=True)` for each of the first
`OPERATOR_RUN_TICKS` (4) ticks that
`fixtures/operator/headline_5000x100_ticks.json` recorded of the JAX
reference's operator (a full provisioning pass, then launch, registration,
binding and two consolidation rounds; `--only operator` drives all 8).
Each tick's canonical state (NodeClaims, Nodes, each pod's node, events,
counters) has the fixture's digest, its solves the fixture's modes and
notes, its disruption commands the fixture's; after the fixture's last
tick the state equals the fixture's in full. The counts
are set to 0 before each tick and read after it: K1-K3 once per pack, K4
once per delta that removes pods, K5 and K6 once per LP decision, as the
recorded solves say; each kept pack, recredit, K5 and K6 call is run again
against its plain version. Each tick's wall ms is printed once, split into
the provisioner, the binder, the NodeClaim lifecycle, the disruption
controller and the rest.

Then the serving phase (`check_serving`), against
`fixtures/serving/churn_5000x100.json` (the JAX reference's runs of
`testing/serving.py`'s scenarios): the headline churn (5000 base pods, 100
types, 800 arrivals, 600 cancellations and 800 departures a cycle, 32
steady solves) in a `ChurnHarness` on the card, every solve's mode and the
placement digest after every bind flush the reference's, each solve's
launches as its trace says (K1-K3 per full and adding delta solve, K4 per
removing delta), no kernel-library load in the steady window, the first
full pack, delta pack and recredit held to their plain versions; after a
node's revocation `repack_savings("global")` (K5, K6) the reference's; a
1.5 s concurrent segment with the prestager's worker thread (invariants
only); four fleet tenants of 1250 pods on a `FleetFrontend` (each
tenant's modes, digests and report the reference's); a `ShardRouter` of
two worker processes on the card replaying the tenants' logs to the
fleet's digests, one worker killed and its tenants re-homed, the kernel
library built once for all; and `python -m karpenter_tpu_torch` (single
cluster, then two shards) answering its routes and exiting 0 on SIGTERM.

Then the delta path: every chain in `fixtures/chains/` is driven through
`GPUSolver().solve_encoded` step by step, the counts set to 0 before each
step and read after it. Each step must give the reference's mode and
delta-reject reason, assignment, basis, zoneset, open count and resident
carry, with 0 validation errors, and launch exactly the kernels the
reference's step ran (K4 where it re-credited, K1-K3 where it packed a
delta). Each recredit (K4) and delta pack (K1 -> K2 -> K3) the path made is
then repeated on its recorded inputs and held against its plain version and
the stored JAX carry; K4 also on synthetic recredits (`recredit_cases`:
many removals on one slot, padding over a -0.0, K = 1500 and 12000), bit
for bit.

Then the consolidation proposers: for every fixture in
`fixtures/consolidation/`, K5 globalpack (after 1, 5 and 300 Adam steps
from the stored JAX inits), K6 score_subsets (on the reference's rounded
rows) and K7 anneal (on the reference's random streams; its pre-pass, the
bit-packed compatibility rows and the undominated replacement rows, also on
its own) against their plain versions on the card and the stored JAX
outputs. Each proposer is then
driven end to end on its fixture (`propose_problem_lp` on the 5000-node
fleet, `propose_problem_global` on the 5000-node spot/on-demand fleet
without and with 200 pending pods, `propose_problem_anneal` on the 256-node
anneal fleet; each from the JAX inits, and the global one also through
`GPUSolver().global_repack_plan_encoded`, which draws the reference's inits
itself), the counts
set to 0 just before each call and read just after: the LP and global
proposers must launch K5 once and K6 once, the anneal proposer K7 and its
pre-pass once each, and give the JAX proposals.

Then the axis caps (`check_caps`): the problems of `fixtures/caps/`, past
every axis limit the kernels once had (G = 264 groups; R = 20 resources,
D = 121 domain values, Q = 36 ranks, Kd = 40 keys, 40 host ports; R = 20
with Qp = 128 classes), and a synthetic round at Np = 32768 whose K5 and K7
state is past their shared-memory budget: K1, K2 (a full pack and the same
items again from its carry) and K8 bit for bit against their plain
versions and the stored JAX outputs; K5 within D_TOL of its plain version;
K6 and K7 bit for bit against theirs (and JAX's, on the fixtures); K6 also
at Np = 256, 8192 and 32768 (`K6_SIZES`: a cluster of one block, of eight
blocks of one 1024-node tile, of eight of four), without and with pending
pods. The LP
proposer is also driven on `lp_300_near_tie`, whose JAX d has two real
nodes 3.6e-7 apart at a prefix boundary, and must give the JAX proposals.

Then the per-pod pack: for every fixture, K1 over the pods and K8
perpod_pack against their plain versions on the card (the five outputs and
the whole final carry), the five outputs against the stored JAX per-pod pack
(`fixtures/perpod/`) and the `fast_validate` errors against the reference's
own (the per-pod scan ignores host ports and required affinity, so those
are not 0 everywhere); K8 also on the synthetic problems of
`PERPOD_REGIME_CASES`, whose open-slot counts stay below, cross, start at and
start past the 64 open slots up to which one warp searches alone (the five
outputs and the whole carry against its plain version). Its entry,
`greedy_pack_encoded`, is driven on both
headlines with the counts set to 0 just before and read just after: exactly
one K1 and one K8 launch each.

Last it times each kernel, its plain version and the library yardstick with
CUDA events at the headline shape (K4 and the delta pack at the headline
churn step; K5-K7 at the 5000-node shapes, K7 also at the 5000-node fleet's
Np = 8192 with the dense compatibility matrix; K8 and K1 over the 5000
pods at the headline, K8 also at the existing fleets of 1200 and 3800
nodes), the full solve, the delta solve beside a full solve
of the same problem, the LP and global proposers at 5000 nodes and the
per-pod pack, with stage breakdowns (host clock, device synchronised). K2
is also timed per `place()` call at both headlines, the churn step and
the existing fleets of 1200 and 3800 nodes (open slots past its
shared-memory tile); K3 (at the headline and the churn step), K4, K6
and `index_add_` also from a replayed CUDA graph, which leaves out the
host's time to issue each call. K1 is timed at each of its call sites
(`k1_sites`: both headlines' items, the churn step's, the headline's 5000
pods, `existing_fleet_3800`, `caps_wide`) eagerly and from a replayed
CUDA graph, each beside an empty kernel's launch timed the same two ways.

Output: a `kernels` JSON line, the card line, then as the last line
`{"ok": true, "device": {...}}`. Any mismatch or exception exits non-zero.
`python3 chip_smoke.py --only dra` (or `--only wide`, `--only operator`,
`--only serving`) runs just the DRA (the wide, the operator, the serving)
phase after the build and prints its result in place of the `kernels` line.
Without a CUDA device, or without the rest of the repository beside it, it
exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import fields, replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "karpenter_tpu_torch" / "fixtures"
HEADLINE = "headline_5000x100"
HEADLINE_AFF = "headline_aff_5000x100"
CHURN = "churn_headline_5000x100"  # the headline churn chain; step 1 is timed
FLEET = "existing_fleet_1200"  # 1200 existing nodes: an active slot range past K2's shared-memory tile
FLEET_BIG = "existing_fleet_3800"  # 3800 existing nodes: ~3800 open slots of N = 4608
STATE_LEAVES = ("slot_basis", "slot_rem", "slot_zoneset", "slot_rank", "counts_zone", "counts_host", "open_count",
                "port_any", "port_wild", "port_spec")
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# non-tensor-core f32 rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
REPLACES = {
    "feasibility": "karpenter_tpu/models/scheduler_model.py:436",
    "pack_scan": "karpenter_tpu/models/scheduler_model_grouped.py:1028",
    "pack_scan_sharded": "karpenter_tpu/parallel/sharded.py:177",
    "pack_scan_cluster": "karpenter_tpu/parallel/sharded.py:177",
    "sparsify": "karpenter_tpu/models/scheduler_model_grouped.py:1012",
    "recredit": "karpenter_tpu/models/scheduler_model_grouped.py:1111",
    "globalpack": "karpenter_tpu/models/globalpack.py:97",
    "score_subsets": "karpenter_tpu/models/globalpack.py:212",
    # the pre-pass packs anneal_chains' dense compatibility matrix (its max over
    # pod_compat[j, :] * x at :84) and its replacement rows
    "anneal_pack": "karpenter_tpu/models/consolidation_model.py:103",
    "anneal": "karpenter_tpu/models/consolidation_model.py:103",
    "perpod_pack": "karpenter_tpu/models/scheduler_model.py:508",
}
SOURCES = {"feasibility": "feasibility.cu", "pack_scan": "pack_scan.cu", "pack_scan_sharded": "pack_scan_sharded.cu",
           "pack_scan_cluster": "pack_scan_cluster.cu",
           "sparsify": "sparsify.cu",
           "recredit": "recredit.cu", "globalpack": "globalpack.cu", "score_subsets": "score_subsets.cu",
           "anneal_pack": "anneal.cu", "anneal": "anneal.cu", "perpod_pack": "perpod_pack.cu"}
CONS = FIXTURES / "consolidation"
CONS_LP, CONS_GLOBAL, CONS_PENDING, CONS_ANNEAL = ("lp_5000", "global_5000_hetero", "global_5000_hetero_pending",
                                                   "anneal_256")
# two real nodes of its JAX d 3.6e-7 apart at a prefix boundary (tests/test_torch_consolidation.py)
CONS_NEAR_TIE = "lp_300_near_tie"
# K5 against its plain version and the reference: d within D_TOL; the
# objective within these (relative after 1 and 5 steps; after the full
# ascent, a share of the fleet's total node price). tests/test_torch_globalpack.py
D_TOL = 2e-6
GP_SCORE_TOL = {1: 5e-2, 5: 1e-4}
GP_FINAL_TOL = 1e-2


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nbytes(*tensors) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tensors)


def same_bits(a, b) -> bool:
    """f32 tensors equal bit for bit (-0.0 != +0.0, a NaN equals its own bits)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs(*pairs) -> float:
    """Largest |kernel - plain| over output pairs (bools and ints as numbers)."""
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0 for a, b in pairs)


def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    measured with CUDA events after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def graph_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device time of one call: `reps` calls captured in a CUDA graph after
    a warm-up call, the graph replayed `rounds` times between CUDA events;
    the median per call. Unlike `cuda_ms` it leaves out the host's time to
    issue each call, which bounds a launch of a few microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def prepare(name: str, dev):
    """Load a fixture and build its device inputs the way solve_encoded does."""
    from karpenter_tpu_torch.models.scheduler_model import make_tensors, reset_bucket_highwater
    from karpenter_tpu_torch.models.scheduler_model_grouped import build_items, make_item_tensors, nnz_cap_for
    from karpenter_tpu_torch.solver.encoded import load_npz
    from karpenter_tpu_torch.solver.gpu import SLOT_CAP

    reset_bucket_highwater()
    problem, ref = load_npz(FIXTURES / f"{name}.npz")
    arrays, _pods = build_items(problem)
    items = make_item_tensors(arrays, dev)
    n_slots = int(ref["ref_n_slots"])
    t = make_tensors(problem, dev, n_slots=problem.n_existing + min(problem.n_pods, SLOT_CAP))
    if t.n_slots != n_slots:  # the reference retried with the uncapped slot axis
        t = make_tensors(problem, dev)
    expect(t.n_slots == n_slots, f"{name}: slot axis {t.n_slots} != reference {n_slots}")
    nnz_cap = nnz_cap_for(problem.n_pods, items.item_req.shape[0], t.n_slots)
    expect(nnz_cap == int(ref["ref_nnz_cap"]), f"{name}: nnz_cap {nnz_cap} != reference")
    return problem, ref, t, items, nnz_cap


def check_kernels(name: str, dev) -> dict:
    """Each kernel against its plain version on the card, and the pack's
    outputs against the stored JAX reference."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import feasibility, feasibility_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan, pack_scan_plain
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs, flat_outputs_plain
    from karpenter_tpu_torch.models.scheduler_model_grouped import ItemTensors

    problem, ref, t, items, nnz_cap = prepare(name, dev)
    compat, key = feasibility(t, items)
    compat_p, key_p = feasibility_plain(t, items)
    torch.cuda.synchronize()
    expect(torch.equal(compat, compat_p), f"{name}: K1 compat differs from plain")
    expect(same_bits(key, key_p), f"{name}: K1 key differs from plain")

    takes, left, state = pack_scan(t, items, compat, key, n_slots=t.n_slots)
    takes_p, left_p, state_p = pack_scan_plain(t, items, n_slots=t.n_slots, precomputed=(compat_p, key_p))
    torch.cuda.synchronize()
    leaves = list(state[:7]) + list(state[7])
    leaves_p = list(state_p[:7]) + list(state_p[7])
    names = STATE_LEAVES
    expect(torch.equal(takes, takes_p), f"{name}: K2 takes differ from plain")
    expect(torch.equal(left, left_p), f"{name}: K2 leftovers differ from plain")
    for leaf, a, b in zip(names, leaves, leaves_p):
        expect(torch.equal(a, b), f"{name}: K2 carry {leaf} differs from plain")
        stored = torch.as_tensor(ref[f"ref_state_{leaf}"]).to(a.dtype)
        expect(torch.equal(a.cpu(), stored.reshape(a.shape)), f"{name}: K2 carry {leaf} differs from the JAX reference")

    # the carry contract of the delta path: the first half of the items,
    # then the rest from the returned carry, equals one pass
    cut = items.item_req.shape[0] // 2
    halves = [ItemTensors(**{f.name: getattr(items, f.name)[lo:hi] for f in fields(ItemTensors)})
              for lo, hi in ((0, cut), (cut, items.item_req.shape[0]))]
    t1, l1, s1 = pack_scan(t, halves[0], compat[:cut], key[:cut], n_slots=t.n_slots)
    t2, l2, s2 = pack_scan(t, halves[1], compat[cut:], key[cut:], n_slots=t.n_slots, init_state=s1)
    torch.cuda.synchronize()
    expect(torch.equal(torch.cat([t1, t2]), takes) and torch.equal(torch.cat([l1, l2]), left),
           f"{name}: K2 continued from a carry differs from one pass")
    for leaf, a, b in zip(names, list(s2[:7]) + list(s2[7]), leaves):
        expect(torch.equal(a, b), f"{name}: K2 carry {leaf} continued from a carry differs from one pass")

    flat = flat_outputs(takes, left, state[0], state[2], state[6], nnz_cap)
    flat_p = flat_outputs_plain(takes_p, left_p, state_p[0], state_p[2], state_p[6], nnz_cap)
    torch.cuda.synchronize()
    expect(torch.equal(flat, flat_p), f"{name}: K3 flat output differs from plain")
    ref_flat = torch.as_tensor(ref["ref_flat"]).to(torch.int32)
    expect(torch.equal(flat.cpu(), ref_flat), f"{name}: flat output differs from the JAX reference")
    errs = {
        "feasibility": max_abs((compat, compat_p), (key, key_p)),
        "pack_scan": max_abs((takes, takes_p), (left, left_p), *zip(leaves, leaves_p)),
        "sparsify": max_abs((flat, flat_p)),
    }
    return dict(name=name, W=int(items.item_req.shape[0]), N=t.n_slots, errs=errs)


def run_main_path(name: str, dev) -> tuple[dict, dict]:
    """GPUSolver.solve_encoded with every launch count set to 0 just before
    and read just after."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.encoded import load_npz
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    problem, ref = load_npz(FIXTURES / f"{name}.npz")
    solver = GPUSolver(dev)
    reset_bucket_highwater()
    build.reset_launches()
    res = solver.solve_encoded(problem)
    counts = dict(build.LAUNCHES)
    expect(res.errors == [], f"{name}: validation errors {res.errors}")
    expect(res.n_placed == problem.n_pods, f"{name}: placed {res.n_placed} of {problem.n_pods}")
    expect(bool((res.assignment == ref["ref_assignment"]).all()), f"{name}: assignment differs from the JAX reference")
    expect(res.open_count == int(ref["ref_open_count"]), f"{name}: open count differs from the JAX reference")
    for k in ("feasibility", "pack_scan", "sparsify"):
        expect(counts[k] > 0, f"{name}: kernel {k} was not launched on the main path")
    expect(counts["recredit"] == 0, f"{name}: a full solve launched the recredit kernel")
    return counts, dict(placed=res.n_placed, pods=problem.n_pods, open=res.open_count, items=res.item_info["n_items"])


# -- the snapshot phase: the port's own object model, encoder and solve ------------------

SNAPSHOT_FIXTURE = FIXTURES / "snapshot" / "headline_5000x100_seeded.npz"
SNAPSHOT_SHAPE = (5000, 100)  # pods x instance types: the headline
SNAPSHOT_DELTA = (600, 800)  # the delta step: pods removed, pods appended by the builder
SNAPSHOT_SEED = 0  # the uids' generator and the delta step's removals (the fixture's)


def seeded_snapshot(seed: int = SNAPSHOT_SEED, build_snapshot=None, names=None, fallback_frac: float = 0.0,
                    shape: tuple = SNAPSHOT_SHAPE):
    """The headline `SolverSnapshot`, the pods its delta step appends and
    the one pod the solve phase's last step appends (`bench.py`'s warm
    one-pod delta: 500m, 512Mi), made by `build_snapshot` (the port's
    `testing/scenarios.build_snapshot` by default) with pod names counted
    from pod-1 (`names` is the module whose `_seq` counter names pods and
    whose `make_pod` makes the one pod) and every uid drawn from a generator
    seeded with `seed` (the FFD queue and the encoder order pods by uid).
    `fallback_frac` is the share of the headline's pods that carry a
    preferred pod affinity (`bench.py`'s out-of-window pods; the hybrid
    phase's snapshot has 0.05); `shape` is (pods, instance types), the
    headline's unless the wide phase asks for 1000 types. The fixtures'
    writers run the same recipe over the reference's build functions."""
    import itertools
    import random
    import uuid

    if build_snapshot is None:
        from karpenter_tpu_torch.testing import scenarios as names

        build_snapshot = names.build_snapshot
    names._seq = itertools.count(1)
    rng = random.Random(seed)
    real = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
    try:
        snap = build_snapshot(*shape, fallback_frac=fallback_frac)
        added = build_snapshot(SNAPSHOT_DELTA[1], shape[1]).pods
        one = names.make_pod(cpu="500m", memory="512Mi")
    finally:
        uuid.uuid4 = real
    return snap, added, one


def delta_step_pods(pods: list, added: list, seed: int = SNAPSHOT_SEED, n_removed: int = SNAPSHOT_DELTA[0]) -> list:
    """`pods` with `n_removed` of them (drawn with `seed`) removed, the
    survivors in order, and `added` appended."""
    import numpy as np

    drop = set(np.random.default_rng(seed).choice(len(pods), n_removed, replace=False).tolist())
    return [p for i, p in enumerate(pods) if i not in drop] + list(added)


# the solve phase's steps over the seeded headline, and the reference's
# Results for them (written by `tests/test_torch_solve.py --write`)
SOLVE_FIXTURE = FIXTURES / "snapshot" / "headline_5000x100_seeded_results.json"
SOLVE_STEPS = ("step 0", "resubmit", "step 1", "step 2")


def solve_step_pods(base: list, added: list, one) -> list:
    """The pod list of each solve step: the headline (a full solve), the
    same again (an identical resubmit), the delta step (600 removed, 800
    appended) and the delta step with `one` more pod appended."""
    step1 = delta_step_pods(base, added)
    return [list(base), list(base), step1, step1 + [one]]


def expect_encoding(enc, stored: dict, step: int) -> None:
    """Every numpy array and name list of the port's encoding equals the
    fixture's (written by the JAX package from the same seeded build)."""
    import numpy as np

    from karpenter_tpu_torch.solver.encoded import encoding_arrays

    pre = f"s{step}."
    want = {k[len(pre):]: v for k, v in stored.items() if k.startswith(pre) and not k.startswith(pre + "ref_")}
    got = encoding_arrays(enc)
    expect(sorted(got) == sorted(want), f"snapshot step {step}: encoding fields {sorted(set(got) ^ set(want))} differ")
    for key, w in want.items():
        g = np.asarray(got[key])
        expect(g.dtype == w.dtype and g.shape == w.shape and bool(np.array_equal(g, w)),
               f"snapshot step {step}: encoding {key} differs from the JAX reference's")


def expect_placement(res, solver, stored: dict, step: int, counts: dict, mode: str) -> None:
    what = f"snapshot step {step}"
    expect(solver.last_solve_mode == mode == str(stored[f"s{step}.ref_mode"]),
           f"{what}: mode {solver.last_solve_mode}, reference {stored[f's{step}.ref_mode']}")
    expect(res.errors == [], f"{what}: validation errors {res.errors[:3]}")
    expect(bool((res.assignment == stored[f"s{step}.ref_assignment"]).all()),
           f"{what}: assignment differs from the JAX reference")
    expect(res.open_count == int(stored[f"s{step}.ref_open_count"]), f"{what}: open count differs from the JAX reference")
    want = dict(feasibility=1, pack_scan=1, sparsify=1, recredit=int(mode == "delta"))
    for k, n in want.items():
        expect(counts[k] == n, f"{what}: kernel {k} launched {counts[k]} times, not {n}")


def clone_carry(state):
    """A copy of a pack carry (seven tensors and the port tuple)."""
    return tuple(x.clone() for x in state[:7]) + (tuple(x.clone() for x in state[7]),)


def carry_leaves(state) -> list:
    return list(state[:7]) + list(state[7])


@contextmanager
def kept_snapshot_inputs(seen: dict):
    """Keep the inputs (a copy of any carry, taken before the call) and the
    outputs of every pack (`_pack_flat`: K1 -> K2 -> K3) and recredit (K4)
    the path makes, in `seen["pack"]` and `seen["rc"]`."""
    import karpenter_tpu_torch.kernels.recredit as k4
    import karpenter_tpu_torch.models.scheduler_model_grouped as grouped

    real_k4, real_pack = k4.recredit, grouped._pack_flat

    def recredit(state, t, *args):
        kept = clone_carry(state)
        out = real_k4(state, t, *args)
        seen["rc"].append((kept, t, args, out))
        return out

    def pack_flat(t, items, nnz_cap, init_state=None):
        kept = None if init_state is None else clone_carry(init_state)
        out = real_pack(t, items, nnz_cap, init_state=init_state)
        seen["pack"].append((t, items, nnz_cap, kept, out))
        return out

    k4.recredit, grouped._pack_flat = recredit, pack_flat
    try:
        yield
    finally:
        k4.recredit, grouped._pack_flat = real_k4, real_pack


def check_snapshot_kernels(seen: dict, what: str, errs: dict) -> None:
    """Each pack and recredit a snapshot solve made, repeated on its kept
    inputs: the kernel against its plain version and against the solve's
    own output, bit for bit (K2 with every carry leaf)."""
    plain_reruns(kernel_reruns({k: seen[k] for k in ("rc", "pack")}, what), what, errs)


def kernel_reruns(seen: dict, what: str) -> list:
    """Each kept call of `seen` (`kept_snapshot_inputs`: "pack", "rc";
    `kept_proposer_inputs`: "k5", "k6") run again through its kernel on
    its kept inputs and held to the path's own output, bit for bit. Returns
    the jobs of the plain half (`plain_reruns`): per call its kind, inputs
    and the kernel's outputs."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import feasibility
    from karpenter_tpu_torch.kernels.globalpack import globalpack
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan
    from karpenter_tpu_torch.kernels.recredit import recredit
    from karpenter_tpu_torch.kernels.score_subsets import score_subsets_packed, unpack
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs

    jobs = []
    for state, t, args, path_out in seen.get("rc", ()):
        got = recredit(state, t, *args)
        torch.cuda.synchronize()
        for leaf, a, c in zip(STATE_LEAVES, carry_leaves(got), carry_leaves(path_out)):
            expect(torch.equal(a, c), f"{what}: K4 {leaf} differs from the solve's")
        jobs.append(("rc", (state, t, args), got))
    for t, items, nnz, init, path_out in seen.get("pack", ()):
        compat, key = feasibility(t, items)
        takes, left, out = pack_scan(t, items, compat, key, n_slots=t.n_slots, init_state=init)
        flat = flat_outputs(takes, left, out[0], out[2], out[6], nnz)
        torch.cuda.synchronize()
        for leaf, a, c in zip(STATE_LEAVES, carry_leaves(out), carry_leaves(path_out["state"])):
            expect(torch.equal(a, c), f"{what}: K2 carry {leaf} differs from the solve's")
        expect(torch.equal(flat, path_out["flat"]), f"{what}: K3 flat output differs from the solve's")
        jobs.append(("pack", (t, items, nnz, init), (compat, key, takes, left, out, flat)))
    for args, (d_path, s_path) in seen.get("k5", ()):
        d, s = globalpack(*args)
        torch.cuda.synchronize()
        expect(torch.equal(d, d_path) and torch.equal(s, s_path), f"{what}: K5 differs from the round's own call")
        jobs.append(("k5", args, d))
    for args, packed_path in seen.get("k6", ()):
        packed = score_subsets_packed(*args)
        torch.cuda.synchronize()
        expect(torch.equal(packed, packed_path), f"{what}: K6 differs from the round's own call")
        jobs.append(("k6", args, unpack(packed, int(args[-1].shape[0]))))
    return jobs


def plain_reruns(jobs: list, what: str, errs: dict) -> None:
    """The plain half of `kernel_reruns`' jobs: each call's plain version on
    the same inputs against the kernel's outputs, bit for bit (K5's d within
    D_TOL); the largest differences go into `errs`."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import feasibility_plain
    from karpenter_tpu_torch.kernels.globalpack import globalpack_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan_plain
    from karpenter_tpu_torch.kernels.recredit import recredit_plain
    from karpenter_tpu_torch.kernels.score_subsets import score_subsets_plain
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs_plain

    for kind, inputs, got in jobs:
        if kind == "rc":
            state, t, args = inputs
            plain = recredit_plain(state, t, *args)
            pairs = list(zip(carry_leaves(got), carry_leaves(plain)))
            for leaf, (a, b) in zip(STATE_LEAVES, pairs):
                expect(torch.equal(a, b), f"{what}: K4 {leaf} differs from plain")
            errs["recredit"] = max(errs["recredit"], max_abs(*pairs))
        elif kind == "pack":
            t, items, nnz, init = inputs
            compat, key, takes, left, out, flat = got
            compat_p, key_p = feasibility_plain(t, items)
            takes_p, left_p, out_p = pack_scan_plain(t, items, n_slots=t.n_slots, init_state=init,
                                                     precomputed=(compat_p, key_p))
            flat_p = flat_outputs_plain(takes_p, left_p, out_p[0], out_p[2], out_p[6], nnz)
            expect(torch.equal(compat, compat_p), f"{what}: K1 compat differs from plain")
            expect(same_bits(key, key_p), f"{what}: K1 key differs from plain")
            expect(torch.equal(takes, takes_p) and torch.equal(left, left_p), f"{what}: K2 differs from plain")
            leaves = list(zip(carry_leaves(out), carry_leaves(out_p)))
            for leaf, (a, b) in zip(STATE_LEAVES, leaves):
                expect(torch.equal(a, b), f"{what}: K2 carry {leaf} differs from plain")
            expect(torch.equal(flat, flat_p), f"{what}: K3 flat output differs from plain")
            errs["feasibility"] = max(errs["feasibility"], max_abs((compat, compat_p), (key, key_p)))
            errs["pack_scan"] = max(errs["pack_scan"], max_abs((takes, takes_p), (left, left_p), *leaves))
            errs["sparsify"] = max(errs["sparsify"], max_abs((flat, flat_p)))
        elif kind == "k5":
            d_p, _s_p = globalpack_plain(*inputs)
            err = max_abs((got, d_p))
            errs["globalpack"] = max(errs["globalpack"], err)
            expect(err <= D_TOL, f"{what}: K5 d differs from plain by {err}")
        else:
            s, f = got
            s_p, f_p = score_subsets_plain(*inputs)
            errs["score_subsets"] = max(errs["score_subsets"], max_abs((s, s_p), (f, f_p)))
            expect(torch.equal(s, s_p) and torch.equal(f, f_p), f"{what}: K6 differs from plain")


def check_snapshot(dev, card: str, errs: dict, runs: int = 5) -> dict:
    """The snapshot phase: the port builds the seeded headline snapshot,
    encodes it (equal to the fixture array by array), solves it on the card
    (K1-K3 once each, no K4; the JAX assignment and open count), then takes
    one delta step through its EncodeCache (600 pods removed, 800 appended)
    solved from the resident carry (K4 and K1-K3 once each; the JAX delta
    reference). Each kernel the two solves launched is run again on its
    kept inputs against its plain version (`check_snapshot_kernels`). Then
    it times, median of `runs` warm runs: the full encode, the delta encode
    and snapshot to placement (encode, copy to the device path's problem,
    `solve_encoded`)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.encode import EncodeCache, encode
    from karpenter_tpu_torch.solver.encoded import from_reference
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    with np.load(SNAPSHOT_FIXTURE, allow_pickle=False) as z:
        stored = {k: z[k] for k in z.files}
    expect(int(stored["seed"]) == SNAPSHOT_SEED,
           f"the snapshot fixture was written for seed {int(stored['seed'])}, not {SNAPSHOT_SEED}")
    t0 = time.perf_counter()
    snap, added, _one = seeded_snapshot()
    build_s = time.perf_counter() - t0
    base_pods = list(snap.pods)
    step_pods = delta_step_pods(base_pods, added)

    cache = EncodeCache()
    enc0 = encode(snap, cache=cache)
    expect_encoding(enc0, stored, 0)
    problem0 = from_reference(enc0)
    solver = GPUSolver(dev)
    reset_bucket_highwater()
    seen0: dict = {"pack": [], "rc": []}
    with kept_snapshot_inputs(seen0):
        build.reset_launches()
        res0 = solver.solve_encoded(problem0)
        full_counts = dict(build.LAUNCHES)
    expect_placement(res0, solver, stored, 0, full_counts, "full")
    expect(len(seen0["pack"]) == 1 and not seen0["rc"], "snapshot step 0: not one pack and no recredit")
    check_snapshot_kernels(seen0, "snapshot step 0", errs)

    snap.pods = step_pods
    enc1 = encode(snap, cache=cache)
    expect(enc1.delta_base is enc0, "snapshot step 1: the encode did not take the delta path")
    expect_encoding(enc1, stored, 1)
    problem1 = from_reference(enc1, base=problem0)
    seen1: dict = {"pack": [], "rc": []}
    with kept_snapshot_inputs(seen1):
        build.reset_launches()
        res1 = solver.solve_encoded(problem1)
        delta_counts = dict(build.LAUNCHES)
    expect_placement(res1, solver, stored, 1, delta_counts, "delta")
    expect(len(seen1["pack"]) == 1 and len(seen1["rc"]) == 1, "snapshot step 1: not one pack and one recredit")
    check_snapshot_kernels(seen1, "snapshot step 1", errs)
    del seen0, seen1
    print(f"snapshot {SNAPSHOT_SHAPE[0]}x{SNAPSHOT_SHAPE[1]} (seed {SNAPSHOT_SEED}, built in {build_s:.2f} s): encoding "
          f"== JAX reference, {res0.n_placed} placed, open {res0.open_count}, launches {full_counts}; delta step "
          f"(-{SNAPSHOT_DELTA[0]} +{SNAPSHOT_DELTA[1]}, {problem1.n_pods} pods): encoding == JAX reference, "
          f"{res1.n_placed} placed, open {res1.open_count}, launches {delta_counts}; K1-K4 on both solves' "
          "inputs == plain == the solves' outputs")

    full_ms, delta_ms, e2e_ms, e2e_stages = [], [], [], []
    for _ in range(runs + 1):
        snap.pods = base_pods
        t0 = time.perf_counter()
        enc = encode(snap, cache=EncodeCache())
        full_ms.append((time.perf_counter() - t0) * 1e3)
        expect(getattr(enc, "delta_base", None) is None and enc.n_pods == len(base_pods),
               "timed full encode took another path")

        cache = EncodeCache()
        encode(snap, cache=cache)
        snap.pods = step_pods
        t0 = time.perf_counter()
        enc = encode(snap, cache=cache)
        delta_ms.append((time.perf_counter() - t0) * 1e3)
        expect(enc.delta_base is not None, "timed delta encode took the full path")

        snap.pods = base_pods
        reset_bucket_highwater()
        timed = GPUSolver(dev)  # a fresh solver: every run is a full solve
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode(snap, cache=EncodeCache())
        t1 = time.perf_counter()
        problem = from_reference(enc)
        t2 = time.perf_counter()
        res = timed.solve_encoded(problem)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        expect(res.errors == [] and res.n_placed == problem.n_pods, "timed snapshot solve failed validation")
        e2e_ms.append((t3 - t0) * 1e3)
        e2e_stages.append(dict(encode=(t1 - t0) * 1e3, copy=(t2 - t1) * 1e3, solve_encoded=(t3 - t2) * 1e3))
    out = dict(encode_ms=statistics.median(full_ms[1:]), delta_encode_ms=statistics.median(delta_ms[1:]),
               e2e_ms=statistics.median(e2e_ms[1:]), full_counts=full_counts, delta_counts=delta_counts,
               e2e_stages={k: statistics.median(s[k] for s in e2e_stages[1:]) for k in e2e_stages[-1]})
    out["pods_per_s"] = SNAPSHOT_SHAPE[0] / (out["e2e_ms"] / 1e3)
    print(f"time encode {SNAPSHOT_SHAPE[0]}x{SNAPSHOT_SHAPE[1]} (full, host): median of {runs} warm runs "
          f"{out['encode_ms']:.3f} ms (runs ms: {[round(x, 3) for x in full_ms]}) on {card}")
    print(f"time delta encode (-{SNAPSHOT_DELTA[0]} +{SNAPSHOT_DELTA[1]}, host): median of {runs} warm runs "
          f"{out['delta_encode_ms']:.3f} ms (runs ms: {[round(x, 3) for x in delta_ms]}) on {card}")
    print(f"time snapshot to placement {SNAPSHOT_SHAPE[0]}x{SNAPSHOT_SHAPE[1]}: median of {runs} warm runs "
          f"{out['e2e_ms']:.3f} ms, {out['pods_per_s']:.1f} pods/s (runs ms: {[round(x, 3) for x in e2e_ms]}; "
          "stages ms: " + ", ".join(f"{k} {v:.3f}" for k, v in out["e2e_stages"].items()) + f") on {card}")
    return out


SOLVE_LAUNCHES = (  # kernels each solve step must launch, once each (every other kernel: none)
    ("feasibility", "pack_scan", "sparsify"),  # step 0: the full pack
    (),  # the identical resubmit: served from the carry
    ("recredit", "feasibility", "pack_scan", "sparsify"),  # step 1: removals re-credited, the additions packed
    ("feasibility", "pack_scan", "sparsify"),  # step 2: the one pod packed
)


def check_solve(dev, card: str, errs: dict, runs: int = 5) -> dict:
    """The solve phase: `GPUSolver(cuda).solve(snap)` from the seeded
    headline snapshot to NodeClaims over `SOLVE_STEPS` (a full solve, an
    identical resubmit, the -600 +800 delta, one more pod), the counts set
    to 0 just before each step and read just after. Each step's canonical
    Results, mode, backend and delta-reject reason must equal the JAX
    reference's (`SOLVE_FIXTURE`), with the launches of `SOLVE_LAUNCHES`;
    each pack and recredit a step made is run again on its kept inputs
    against its plain version (`check_snapshot_kernels`). Then it times,
    median of `runs` warm runs, host clock, device synchronised after each
    stage: a cold solve on a fresh solver (encode, copy, pack, decode), the
    identical resubmit, the delta solve and the warm one-pod delta."""
    import json
    import random

    import torch

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.testing import scenarios
    from karpenter_tpu_torch.testing.canonical import canonical_results, json_form

    stored = json.loads(SOLVE_FIXTURE.read_text())
    expect(stored["seed"] == SNAPSHOT_SEED, f"the solve fixture was written for seed {stored['seed']}, not {SNAPSHOT_SEED}")
    snap, added, one = seeded_snapshot()
    pods_of = solve_step_pods(list(snap.pods), added, one)
    reset_bucket_highwater()
    solver = GPUSolver(dev, force=True)  # raises where it would fall back to the host
    paths = []
    for step, pods, want, launched in zip(SOLVE_STEPS, pods_of, stored["steps"], SOLVE_LAUNCHES):
        what = f"solve {step}"
        expect(want["step"] == step, f"{what}: the fixture's step is {want['step']}")
        snap.pods = pods
        random.seed(0)
        seen: dict = {"pack": [], "rc": []}
        with kept_snapshot_inputs(seen):
            build.reset_launches()
            results = solver.solve(snap)
            counts = dict(build.LAUNCHES)
        backend = {"gpu": "tpu"}.get(solver.last_backend, solver.last_backend)
        expect(solver.last_solve_mode != "fallback", f"{what}: the solve fell back to the host")
        got = dict(mode=solver.last_solve_mode, backend=backend, reject=solver.last_delta_reject,
                   reasons=list(solver.last_fallback_reasons))
        for key, value in got.items():
            expect(value == want[key], f"{what}: {key} {value!r}, the JAX reference's {want[key]!r}")
        expect(json_form(canonical_results(results)) == want["results"], f"{what}: Results differ from the JAX reference's")
        need = {k: int(k in launched) for k in counts}
        expect(counts == need, f"{what}: launches {counts}, not {need}")
        expect(len(seen["pack"]) == int("pack_scan" in launched) and len(seen["rc"]) == int("recredit" in launched),
               f"{what}: {len(seen['pack'])} packs and {len(seen['rc'])} recredits")
        check_snapshot_kernels(seen, what, errs)
        del seen
        paths.append({k: v for k, v in counts.items() if v})
        print(f"{what} ({len(pods)} pods): mode {solver.last_solve_mode}, {len(results.new_node_claims)} claims, "
              f"{len(results.pod_errors)} pod errors, Results == JAX reference; launches {paths[-1]}; decode "
              f"{solver.last_decode}")

    def timed(gpu, what: str, mode: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gpu.solve(snap)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        expect(gpu.last_solve_mode == mode and not res.pod_errors, f"timed {what}: mode {gpu.last_solve_mode}")
        return ms, dict(gpu.last_stages)

    base, step1 = pods_of[0], pods_of[2]
    extra = [scenarios.make_pod(cpu="500m", memory="512Mi") for _ in range(runs + 1)]
    cold, resub, delta, one_pod = [], [], [], []
    for r in range(runs + 1):
        reset_bucket_highwater()
        gpu = GPUSolver(dev, force=True, stage_times=True)  # a fresh solver: a cold solve
        snap.pods = base
        cold.append(timed(gpu, "cold solve", "full"))
        resub.append(timed(gpu, "resubmit", "delta"))
        snap.pods = step1
        delta.append(timed(gpu, "delta solve", "delta"))
    for r in range(runs + 1):
        snap.pods = step1 + extra[: r + 1]
        one_pod.append(timed(gpu, "one-pod delta", "delta"))

    def summary(rows):
        ms = [x[0] for x in rows]
        stages = {k: statistics.median(x[1].get(k, 0.0) for x in rows[1:]) for k in rows[-1][1]}
        return dict(ms=statistics.median(ms[1:]), runs=ms, stages=stages)

    out = {name: summary(rows) for name, rows in
           (("cold", cold), ("resubmit", resub), ("delta", delta), ("delta_1pod", one_pod))}
    labels = {"cold": f"cold solve {SNAPSHOT_SHAPE[0]}x{SNAPSHOT_SHAPE[1]} (fresh solver: encode, copy, pack, decode)",
              "resubmit": "identical resubmit (served from the carry)",
              "delta": f"delta solve (-{SNAPSHOT_DELTA[0]} +{SNAPSHOT_DELTA[1]})",
              "delta_1pod": "warm one-pod delta"}
    for name, v in out.items():
        print(f"time snapshot to NodeClaims, {labels[name]}: median of {runs} warm runs {v['ms']:.3f} ms "
              f"(runs ms: {[round(x, 3) for x in v['runs']]}; stages ms: "
              + ", ".join(f"{k} {x:.3f}" for k, x in v["stages"].items()) + f") on {card}")
    return dict(paths=paths, ms={name: v["ms"] for name, v in out.items()},
                decode_ms={name: v["stages"].get("decode", 0.0) for name, v in out.items()},
                stages={name: v["stages"] for name, v in out.items()}, inputs=(snap, pods_of, stored))


# -- the flight-record phase: metrics, traces, the recovery ladder, detcheck --------

def check_observability(dev, card: str, inputs, runs: int = 5) -> dict:
    """The flight-record phase (module docstring) over the solve phase's
    seeded headline snapshot and its `SOLVE_STEPS`."""
    import random

    import torch

    from karpenter_tpu_torch import metrics as pm
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.obs import detcheck
    from karpenter_tpu_torch.obs.trace import TraceRecorder
    from karpenter_tpu_torch.solver.gpu import PORT_SPANS, GPUSolver
    from karpenter_tpu_torch.testing.canonical import canonical_results, json_form

    snap, pods_of, stored = inputs

    def solve(solver, pods, what: str, launched=None, want=None):
        snap.pods = pods
        random.seed(0)
        build.reset_launches()
        results = solver.solve(snap)
        counts = dict(build.LAUNCHES)
        form = json_form(canonical_results(results))
        if want is not None:
            expect(form == want["results"], f"{what}: Results differ from the JAX reference's")
        if launched is not None:
            need = {k: int(k in launched) for k in counts}
            expect(counts == need, f"{what}: launches {counts}, not {need}")
        return form

    def chain(solver, traced: bool) -> list:
        forms = []
        for i, (step, pods, want, launched) in enumerate(zip(SOLVE_STEPS, pods_of, stored["steps"], SOLVE_LAUNCHES)):
            what = f"{'traced' if traced else 'untraced'} {step}"
            forms.append(solve(solver, pods, what, launched, want))
            expect(solver.last_solve_mode == want["mode"], f"{what}: mode {solver.last_solve_mode}")
            tr = solver._trace
            if not traced:
                expect(not tr.enabled and solver.recorder.traces() == [], f"{what}: an untraced solve was kept")
                continue
            expect(solver.recorder.last() is tr and tr.mode == want["mode"] and tr.backend == "gpu",
                   f"{what}: trace mode {tr.mode!r} backend {tr.backend!r}")
            top = [s.name for s in tr.spans]
            inner = [c.name for c in tr.spans[-1].children if c.name not in PORT_SPANS]
            want_inner = ["validate", "decode"] if want["mode"] == "full" else ["decode"]
            expect(top == ["encode", "pack"] and inner == want_inner, f"{what}: spans {top}, pack {inner}")
            expect("encode_mode" in tr.attribution and "decode_mode" in tr.attribution, f"{what}: notes {tr.attribution}")
            if i:
                expect(tr.recompiles == {}, f"{what}: recompiles {tr.recompiles} after the first solve")
            print(f"recorded {step}: mode {tr.mode}, backend {tr.backend}, spans {top} (pack: "
                  f"{[c.name for c in tr.spans[-1].children]}), recompiles {tr.recompiles}, notes "
                  f"{ {k: v for k, v in tr.attribution.items() if k not in ('ffd_memo',)} }")
        return forms

    # the headline chain, recorded and counted, then the same with tracing off
    reg_on, reg_off = pm.make_registry(), pm.make_registry()
    reset_bucket_highwater()
    on = GPUSolver(dev, registry=reg_on, recorder=TraceRecorder(enabled=True))
    forms_on = chain(on, True)
    reset_bucket_highwater()
    off = GPUSolver(dev, registry=reg_off, recorder=TraceRecorder(enabled=False))
    forms_off = chain(off, False)
    expect(forms_on == forms_off, "tracing changed the Results")
    text = reg_on.expose()
    for line in ('karpenter_solver_solve_total{backend="gpu",tenant=""} 4',
                 'karpenter_solver_decode_total{mode="full"}',
                 'karpenter_solver_solve_quantile_seconds{mode="full",phase="total",quantile="p50"}',
                 'karpenter_solver_solve_quantile_seconds{mode="delta",phase="decode",quantile="p99"}'):
        expect(line in text, f"the exposition text lacks {line}")
    for name in (pm.SOLVER_SOLVE_TOTAL, pm.SOLVER_DECODE_TOTAL, pm.SOLVER_DELTA_REJECT_TOTAL):
        expect(sorted(map(str, reg_on.counter(name).collect())) == sorted(map(str, reg_off.counter(name).collect())),
               f"{name} differs between the traced and untraced chains")
    stats = on.recorder.stats()
    print("traced chain == untraced chain == JAX reference; rolling quantiles (s): "
          + ", ".join(f"{k} p50 {v['p50']:.6f} p99 {v['p99']:.6f}" for k, v in stats.items() if k.endswith("/total")))

    # tracing overhead: fresh solvers' full solves and warm resubmits, traced
    # against untraced, alternated
    def full_ms(rec):
        reset_bucket_highwater()
        s = GPUSolver(dev, recorder=rec)
        snap.pods = pods_of[0]
        random.seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.solve(snap)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, s

    full = {True: [], False: []}
    warm = {}
    for _ in range(runs + 1):
        for traced in (True, False):
            ms, warm[traced] = full_ms(TraceRecorder(enabled=traced))
            full[traced].append(ms)
    resub = {True: [], False: []}
    for _ in range(runs + 1):
        for traced in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm[traced].solve(snap)
            torch.cuda.synchronize()
            resub[traced].append((time.perf_counter() - t0) * 1e3)
            expect(warm[traced].last_solve_mode == "delta", "a timed resubmit left the delta path")
    overhead = {}
    for name, rows in (("full", full), ("resubmit", resub)):
        t_on, t_off = statistics.median(rows[True][1:]), statistics.median(rows[False][1:])
        overhead[name] = dict(traced_ms=t_on, untraced_ms=t_off, pct=(t_on / t_off - 1.0) * 100.0,
                              traced_runs=rows[True], untraced_runs=rows[False])
        print(f"tracing overhead, {name} solve of {SNAPSHOT_SHAPE[0]}x{SNAPSHOT_SHAPE[1]} (median of {runs} warm "
              f"solves): traced {t_on:.3f} ms, untraced {t_off:.3f} ms, {overhead[name]['pct']:+.2f}% (runs ms traced "
              f"{[round(x, 3) for x in rows[True]]}, untraced {[round(x, 3) for x in rows[False]]}) on {card}")

    # the ladder: one fault at "solve" on a warm delta (the resubmit of step 0)
    reg = pm.make_registry()
    reset_bucket_highwater()
    s = GPUSolver(dev, registry=reg, recorder=TraceRecorder(enabled=True))
    solve(s, pods_of[0], "ladder warm-up", SOLVE_LAUNCHES[0], stored["steps"][0])
    calls = []

    def hook(stage):
        calls.append(stage)
        if len(calls) == 1:
            raise RuntimeError("injected solve fault")

    s.fault_hook = hook
    solve(s, pods_of[0], "ladder", SOLVE_LAUNCHES[0], stored["steps"][0])
    s.fault_hook = None
    tr = s._trace
    expect(calls == ["solve", "reencode"] and tr.attribution.get("recovery") == "full-reencode"
           and tr.backend == "gpu" and tr.mode == "full", f"ladder: {calls}, trace {tr.mode} {tr.attribution}")
    expect(reg.counter(pm.SOLVER_RECOVERY_TOTAL).value(stage="full-reencode") == 1
           and reg.counter(pm.SOLVER_RECOVERY_TOTAL).value(stage="host-ffd") == 0, "ladder: recovery counters")
    solve(s, pods_of[1], "after the ladder", SOLVE_LAUNCHES[1], stored["steps"][1])
    expect(s.last_solve_mode == "delta", f"after the ladder: mode {s.last_solve_mode}, not the re-warmed delta")
    s.quarantine_caches()
    solve(s, pods_of[1], "after quarantine", SOLVE_LAUNCHES[0], stored["steps"][1])
    expect(s.last_solve_mode == "full" and s.last_delta_reject == "no-carry",
           f"after quarantine: mode {s.last_solve_mode}, reject {s.last_delta_reject}")
    print("ladder: a fault at 'solve' on a warm delta served through full-reencode (K1-K3 once, Results == JAX "
          "reference), the next solve a delta again, and after quarantine_caches() a full solve (no-carry)")

    # a kernel fault is never absorbed: build.check fails once (a launch's
    # error code), then build.require refuses once (an argument refusal)
    real = {"check": build.check, "require": build.require}
    failed: list = []

    def failing_check(rc: int, what: str) -> None:
        if not failed:
            failed.append(what)
            raise build.KernelError(f"{what}: CUDA error 700 (injected)")
        real["check"](rc, what)

    def failing_require(t, device, dtype, name: str):
        if not failed:
            failed.append(name)
            return real["require"](t, torch.device("cpu"), dtype, name)  # refused: the tensor is on the card
        return real["require"](t, device, dtype, name)

    for attr, fake in (("check", failing_check), ("require", failing_require)):
        failed.clear()
        reg = pm.make_registry()
        s = GPUSolver(dev, registry=reg, recorder=TraceRecorder(enabled=True))
        setattr(build, attr, fake)
        try:
            snap.pods = pods_of[0]
            raised = None
            try:
                s.solve(snap)
            except build.KernelError as e:
                raised = e
        finally:
            setattr(build, attr, real[attr])
        expect(raised is not None and s.last_backend != "ffd-fallback",
               f"a kernel fault at build.{attr} was absorbed by the ladder")
        expect(reg.counter(pm.SOLVER_RECOVERY_TOTAL).total() == 0 and reg.counter(pm.SOLVER_FALLBACK_TOTAL).total() == 0,
               f"a kernel fault at build.{attr} reached the ladder")
        print(f"kernel fault at {failed[0]} (build.{attr}): {type(raised).__name__} propagated, no recovery, "
              "no host answer")

    # determinism: the recorded chain replayed in a child process on this card
    os.environ["KARPENTER_SOLVER_DETCHECK"] = "1"
    detcheck._refresh()
    try:
        reset_bucket_highwater()
        s = GPUSolver(dev)
        for step, pods in zip(SOLVE_STEPS, pods_of):
            solve(s, pods, f"detcheck {step}")
        t0 = time.perf_counter()
        det = s.check_determinism(timeout=600.0)
        det_s = time.perf_counter() - t0
    finally:
        os.environ.pop("KARPENTER_SOLVER_DETCHECK", None)
        detcheck._refresh()
    want_modes = [w["mode"] for w in stored["steps"]]
    expect(det["parent_modes"] == det["child_modes"] == want_modes and det["device"].startswith("cuda"),
           f"detcheck: modes {det['parent_modes']} / {det['child_modes']} on {det['device']}")
    print(f"detcheck: {det['solves']} solves replayed in a child process on {det['device']} under PYTHONHASHSEED="
          f"{det['hash_seed']}, digests {[d[:12] for d in det['digests']]}, modes {det['child_modes']}, child wall "
          f"{det['child_seconds']:.2f} s (check {det_s:.2f} s) on {card}")
    return dict(overhead={k: {x: v[x] for x in ("traced_ms", "untraced_ms", "pct")} for k, v in overhead.items()},
                detcheck_child_s=det["child_seconds"], detcheck_s=det_s)


# -- the hybrid phase: out-of-window snapshots through the default solver ----------

# the hybrid headline: `bench.py`'s `bench_hybrid_path` shape, 5% of the pods
# with a preferred pod affinity (pod-local fallback reasons), and the
# reference's default `TPUSolver` over it (written by
# `tests/test_torch_hybrid.py --write`)
HYBRID_FIXTURE = FIXTURES / "snapshot" / "headline_5000x100_hybrid_results.json"
HYBRID_FALLBACK_FRAC = 0.05
HYBRID_STEPS = ("H0 cold", "H1 resubmit", "H2 one pod", "H3 removal", "H4 residual gone")
HYBRID_LAUNCHES = (  # kernels each hybrid step must launch, once each (every other kernel: none)
    ("feasibility", "pack_scan", "sparsify"),  # H0: the masked problem packed in full
    (),  # H1: an empty masked delta
    ("feasibility", "pack_scan", "sparsify"),  # H2: the one pod packed from the masked carry
    # H3: the removals re-credited into the masked carry; the kept placement
    # fails validation (spread skew), so the cold hybrid packs the masked
    # problem in full, as the reference's step does
    ("recredit", "feasibility", "pack_scan", "sparsify"),
    (),  # H4: only flagged pods left; an empty masked delta, no residual
)
PROVISION_LAUNCHES = ("feasibility", "pack_scan", "sparsify")  # the pass: a cold hybrid solve


def hybrid_step_pods(step: int, pods: list, one, enc) -> list:
    """The pod list of hybrid step `step`, from the previous step's `pods`
    (the headline's on step 0) and encoding `enc` (the solver's EncodeCache
    holds it): the same pods on H0 and H1, `one` appended on H2, 600 pods
    removed on H3 (drawn as `delta_step_pods` draws them) and on H4 every
    pod of a signature the encoding flagged (read by attribute name, so
    either package's encoding serves)."""
    if step <= 1:
        return list(pods)
    if step == 2:
        return list(pods) + [one]
    if step == 3:
        return delta_step_pods(pods, [])
    flagged = {int(s) for s in enc.fallback_sig_local}
    gone = {id(p) for p, s in zip(enc.pods, enc.sig_of_pod) if int(s) in flagged}
    return [p for p in pods if id(p) not in gone]


def pending_store(snap) -> None:
    """Create the snapshot's pods in its store, pending (the provisioner
    reads them there)."""
    for p in snap.pods:
        snap.store.create(p)


def check_hybrid(dev, card: str, errs: dict, runs: int = 5) -> dict:
    """The hybrid phase: `GPUSolver(cuda).solve(snap)` over the hybrid
    headline's `HYBRID_STEPS` (a cold hybrid solve, an identical resubmit,
    one pod appended, 600 pods removed, the flagged pods removed), the
    counts set to 0 just before each step and read just after. Each step's
    canonical Results, mode, backend, fallback and delta-reject reasons
    must equal the JAX reference's (`HYBRID_FIXTURE`), with the launches of
    `HYBRID_LAUNCHES`; each pack and recredit is run again on its kept
    inputs against its plain version. No step may fall back. Then it times,
    median of `runs` warm runs (host clock, device synchronised after each
    stage): a cold hybrid solve on a fresh solver, by stage, and the warm
    one-pod hybrid-delta."""
    import random

    import torch

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.obs.trace import TraceRecorder
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.testing import scenarios
    from karpenter_tpu_torch.testing.canonical import canonical_results, json_form

    stored = json.loads(HYBRID_FIXTURE.read_text())
    expect(stored["seed"] == SNAPSHOT_SEED, f"the hybrid fixture was written for seed {stored['seed']}, not {SNAPSHOT_SEED}")
    snap, _added, one = seeded_snapshot(fallback_frac=HYBRID_FALLBACK_FRAC)
    base = list(snap.pods)
    reset_bucket_highwater()
    solver = GPUSolver(dev, recorder=TraceRecorder(enabled=True))
    pods = base
    paths = []
    for i, (step, want, launched) in enumerate(zip(HYBRID_STEPS, stored["steps"], HYBRID_LAUNCHES)):
        what = f"hybrid {step}"
        expect(want["step"] == step, f"{what}: the fixture's step is {want['step']}")
        pods = hybrid_step_pods(i, pods, one, solver.encode_cache.last_enc)
        snap.pods = pods
        random.seed(0)
        seen: dict = {"pack": [], "rc": []}
        with kept_snapshot_inputs(seen):
            build.reset_launches()
            results = solver.solve(snap)
            counts = dict(build.LAUNCHES)
        expect(solver.last_solve_mode != "fallback", f"{what}: the solve fell back to the host")
        backend = {"gpu": "tpu"}.get(solver.last_backend, solver.last_backend)
        got = dict(mode=solver.last_solve_mode, backend=backend, reject=solver.last_delta_reject,
                   reasons=list(solver.last_fallback_reasons))
        for key, value in got.items():
            expect(value == want[key], f"{what}: {key} {value!r}, the JAX reference's {want[key]!r}")
        expect(json_form(canonical_results(results)) == want["results"], f"{what}: Results differ from the JAX reference's")
        need = {k: int(k in launched) for k in counts}
        expect(counts == need, f"{what}: launches {counts}, not {need}")
        expect(len(seen["pack"]) == int("pack_scan" in launched) and len(seen["rc"]) == int("recredit" in launched),
               f"{what}: {len(seen['pack'])} packs and {len(seen['rc'])} recredits")
        check_snapshot_kernels(seen, what, errs)
        del seen
        paths.append({k: v for k, v in counts.items() if v})
        print(f"{what} ({len(pods)} pods): mode {solver.last_solve_mode}, backend {solver.last_backend}, reject "
              f"{solver.last_delta_reject}, {len(results.new_node_claims)} claims, {len(results.pod_errors)} pod errors, "
              f"Results == JAX reference; launches {paths[-1]}")
        tr = solver.recorder.last()
        expect(tr.mode == solver.last_solve_mode and tr.backend == solver.last_backend, f"{what}: trace {tr.mode}")
        if i == 0:
            expect(tr.attribution.get("residual_pods", 0) > 0, f"{what}: no residual noted")
            print(f"{what} flight record:\n{tr.explain()}")

    def timed(gpu, what: str, mode: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gpu.solve(snap)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        expect(gpu.last_solve_mode == mode and not res.pod_errors, f"timed {what}: mode {gpu.last_solve_mode}")
        return ms, dict(gpu.last_stages)

    extra = [scenarios.make_pod(cpu="500m", memory="512Mi") for _ in range(runs + 1)]
    cold, one_pod = [], []
    for r in range(runs + 1):
        reset_bucket_highwater()
        gpu = GPUSolver(dev, stage_times=True)  # a fresh solver: a cold hybrid solve
        snap.pods = base
        cold.append(timed(gpu, "cold hybrid solve", "hybrid"))
    for r in range(runs + 1):
        snap.pods = base + extra[: r + 1]
        one_pod.append(timed(gpu, "one-pod hybrid-delta", "hybrid-delta"))
    out = {}
    for name, rows, label in (("cold", cold, f"cold hybrid solve {SNAPSHOT_SHAPE[0]}x{SNAPSHOT_SHAPE[1]} (fresh solver)"),
                              ("delta_1pod", one_pod, "warm one-pod hybrid-delta")):
        ms = [x[0] for x in rows]
        stages = {k: statistics.median(x[1].get(k, 0.0) for x in rows[1:]) for k in rows[-1][1]}
        out[name] = dict(ms=statistics.median(ms[1:]), stages=stages)
        print(f"time hybrid snapshot to NodeClaims, {label}: median of {runs} warm runs {out[name]['ms']:.3f} ms "
              f"(runs ms: {[round(x, 3) for x in ms]}; stages ms: "
              + ", ".join(f"{k} {x:.3f}" for k, x in stages.items()) + f") on {card}")
    return dict(paths=paths, ms={k: v["ms"] for k, v in out.items()}, stages={k: v["stages"] for k, v in out.items()})


def check_provision(dev, card: str, errs: dict, runs: int = 5) -> dict:
    """The provisioner phase: a fresh store holding the hybrid headline's
    nodepool and its 5000 pods created pending, wired to its `Cluster`
    (informers), `FakeCloudProvider(instance_types_assorted(100))` and a
    `FakeClock`; one `Provisioner(..., solver=GPUSolver(cuda))
    .reconcile(force=True)`, the counts set to 0 just before and read just
    after. The returned canonical Results, the solver's mode and backend and
    the NodeClaims created in the store must equal the JAX reference's
    pass (`HYBRID_FIXTURE`), with K1-K3 launched once each; each pack is
    run again on its kept inputs against its plain version. Then it times
    one pass on a fresh store and solver, median of `runs` warm runs."""
    import random

    import torch

    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types_assorted
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.testing.canonical import canonical_node_claims, canonical_results, json_form

    want = json.loads(HYBRID_FIXTURE.read_text())["provision"]

    def fresh():
        snap, _added, _one = seeded_snapshot(fallback_frac=HYBRID_FALLBACK_FRAC)
        pending_store(snap)
        reset_bucket_highwater()
        gpu = GPUSolver(dev, stage_times=True)
        cloud = FakeCloudProvider(instance_types_assorted(SNAPSHOT_SHAPE[1]))
        return snap, gpu, Provisioner(snap.store, snap.cluster, cloud, snap.clock, solver=gpu)

    snap, gpu, prov = fresh()
    random.seed(0)
    seen: dict = {"pack": [], "rc": []}
    with kept_snapshot_inputs(seen):
        build.reset_launches()
        results = prov.reconcile(force=True)
        counts = dict(build.LAUNCHES)
    what = "provision"
    expect(results is not None, f"{what}: the pass did not run")
    backend = {"gpu": "tpu"}.get(gpu.last_backend, gpu.last_backend)
    for key, value in (("mode", gpu.last_solve_mode), ("backend", backend)):
        expect(value == want[key], f"{what}: {key} {value!r}, the JAX reference's {want[key]!r}")
    expect(json_form(canonical_results(results)) == want["results"], f"{what}: Results differ from the JAX reference's")
    claims = json_form(canonical_node_claims(snap.store))
    expect(claims == want["claims"], f"{what}: the NodeClaims in the store differ from the JAX reference's")
    need = {k: int(k in PROVISION_LAUNCHES) for k in counts}
    expect(counts == need, f"{what}: launches {counts}, not {need}")
    expect(len(seen["pack"]) == 1 and not seen["rc"], f"{what}: {len(seen['pack'])} packs and {len(seen['rc'])} recredits")
    check_snapshot_kernels(seen, what, errs)
    del seen
    path = {k: v for k, v in counts.items() if v}
    print(f"{what} ({len(snap.pods)} pending pods in the store): mode {gpu.last_solve_mode}, backend {gpu.last_backend}, "
          f"{len(claims)} NodeClaims created, {len(results.pod_errors)} pod errors, Results and NodeClaims == JAX "
          f"reference; launches {path}")

    def split_into(split: dict, obj, name: str, key: str) -> None:
        """Time each call of `obj.name` into `split[key]` (ms)."""
        real = getattr(obj, name)

        def timed_call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                split[key] = split.get(key, 0.0) + (time.perf_counter() - t0) * 1e3

        setattr(obj, name, timed_call)

    passes, stages, splits = [], [], []
    for r in range(runs + 1):
        snap, gpu, prov = fresh()
        split: dict = {}
        for obj, name, key in ((prov, "get_pending_pods", "pending pods"), (prov, "make_snapshot", "snapshot"),
                               (gpu, "solve", "solve"), (prov, "create_node_claim", "create NodeClaims")):
            split_into(split, obj, name, key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prov.reconcile(force=True)
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) * 1e3)
        split["other"] = passes[-1] - sum(split.values())
        splits.append(split)
        stages.append(dict(gpu.last_stages))
        expect(gpu.last_solve_mode == "hybrid" and not res.pod_errors, f"timed provisioning pass: mode {gpu.last_solve_mode}")
    ms = statistics.median(passes[1:])
    med = {k: statistics.median(x.get(k, 0.0) for x in stages[1:]) for k in stages[-1]}
    med_split = {k: statistics.median(x.get(k, 0.0) for x in splits[1:]) for k in splits[-1]}
    print(f"time provisioning pass (Provisioner.reconcile, {SNAPSHOT_SHAPE[0]} pending pods, fresh store and solver): "
          f"median of {runs} warm runs {ms:.3f} ms (runs ms: {[round(x, 3) for x in passes]}; pass ms: "
          + ", ".join(f"{k} {x:.3f}" for k, x in med_split.items()) + "; solver stages ms: "
          + ", ".join(f"{k} {x:.3f}" for k, x in med.items()) + f") on {card}")
    return dict(path=path, ms=ms, stages=med, split=med_split)


# -- the wide phase: the hybrid headline over 1000 instance types -----------------------
WIDE_FIXTURE = FIXTURES / "snapshot" / "headline_5000x1000_hybrid_results.json"
# pods x instance types: the nodepool's amd64/linux requirement leaves 250 of
# the 1000 types, past the C++ requirement table's 200-row threshold
WIDE_SHAPE = (5000, 1000)
WIDE_STEPS = ("W0 cold", "W1 resubmit", "W2 one pod")
WIDE_LAUNCHES = HYBRID_LAUNCHES[:3]  # the hybrid phase's first three steps, at 1000 types


def wide_snapshot(build_snapshot=None, names=None):
    """The seeded hybrid headline over 1000 instance types, the pods its
    delta step would append and the one pod W2 appends (`seeded_snapshot`'s
    recipe, with either package's build functions)."""
    return seeded_snapshot(build_snapshot=build_snapshot, names=names, fallback_frac=HYBRID_FALLBACK_FRAC,
                           shape=WIDE_SHAPE)


@contextmanager
def table_clock(split: dict):
    """While it lasts, the C++ requirement table's builds and filter calls
    are timed into `split["table build"]` and `split["table filter"]` (ms,
    host clock)."""
    from karpenter_tpu_torch import native

    real_init, real_filter = native.ReqTable.__init__, native.ReqTable.filter

    def timed(real, key):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                split[key] = split.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return call

    native.ReqTable.__init__ = timed(real_init, "table build")
    native.ReqTable.filter = timed(real_filter, "table filter")
    try:
        yield
    finally:
        native.ReqTable.__init__, native.ReqTable.filter = real_init, real_filter


def check_wide(dev, card: str, errs: dict, runs: int = 5) -> dict:
    """The wide phase: `GPUSolver(cuda).solve(snap)` over the seeded hybrid
    headline at `WIDE_SHAPE` (1000 instance types, 250 of them compatible),
    `WIDE_STEPS` (a cold hybrid solve, an identical resubmit, one pod
    appended), the launch counts and the C++ requirement table's counts
    (`native.COUNTS`) set to 0 just before each step and read just after.
    Each step's canonical Results, mode, backend, fallback and delta-reject
    reasons must equal the JAX reference's (`WIDE_FIXTURE`), with the
    launches of `WIDE_LAUNCHES`, each pack held to its plain version on its
    kept inputs, and the residual FFD of W0 answered through the table.
    Then it times, median of `runs` warm runs (host clock, device
    synchronised after each stage): a cold hybrid solve on a fresh solver by
    stage (the residual's `ffd.*` spans and the table's build and filter
    time split out), and `FFDSolver().solve` over the same snapshot with the
    table and with its threshold above 1000 rows (the Python algebra),
    alternated, with both arms' Results equal."""
    import random

    import torch

    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.obs.trace import TraceRecorder
    from karpenter_tpu_torch.solver.ffd import FFDSolver
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.testing.canonical import canonical_results, json_form

    stored = json.loads(WIDE_FIXTURE.read_text())
    expect(stored["seed"] == SNAPSHOT_SEED and stored["shape"] == list(WIDE_SHAPE),
           f"the wide fixture was written for seed {stored['seed']} at {stored['shape']}")
    snap, _added, one = wide_snapshot()
    n_types = len(next(iter(snap.instance_types.values())))
    base = list(snap.pods)
    reset_bucket_highwater()
    solver = GPUSolver(dev, recorder=TraceRecorder(enabled=True))
    pods = base
    paths, tables = [], []
    for i, (step, want, launched) in enumerate(zip(WIDE_STEPS, stored["steps"], WIDE_LAUNCHES)):
        what = f"wide {step}"
        expect(want["step"] == step, f"{what}: the fixture's step is {want['step']}")
        pods = hybrid_step_pods(i, pods, one, solver.encode_cache.last_enc)
        snap.pods = pods
        random.seed(0)
        seen: dict = {"pack": [], "rc": []}
        with kept_snapshot_inputs(seen):
            build.reset_launches()
            native.reset_counts()
            results = solver.solve(snap)
            counts = dict(build.LAUNCHES)
            table = dict(native.COUNTS)
        expect(solver.last_solve_mode != "fallback", f"{what}: the solve fell back to the host")
        backend = {"gpu": "tpu"}.get(solver.last_backend, solver.last_backend)
        got = dict(mode=solver.last_solve_mode, backend=backend, reject=solver.last_delta_reject,
                   reasons=list(solver.last_fallback_reasons))
        for key, value in got.items():
            expect(value == want[key], f"{what}: {key} {value!r}, the JAX reference's {want[key]!r}")
        expect(json_form(canonical_results(results)) == want["results"], f"{what}: Results differ from the JAX reference's")
        need = {k: int(k in launched) for k in counts}
        expect(counts == need, f"{what}: launches {counts}, not {need}")
        expect(len(seen["pack"]) == int("pack_scan" in launched) and not seen["rc"],
               f"{what}: {len(seen['pack'])} packs and {len(seen['rc'])} recredits")
        if i == 0:
            expect(table["tables"] > 0 and table["filters"] > 0, f"{what}: the residual FFD did not use the table: {table}")
        check_snapshot_kernels(seen, what, errs)
        del seen
        paths.append({k: v for k, v in counts.items() if v})
        tables.append(table)
        print(f"{what} ({len(pods)} pods, {n_types} instance types): mode {solver.last_solve_mode}, backend "
              f"{solver.last_backend}, {len(results.new_node_claims)} claims, {len(results.pod_errors)} pod errors, "
              f"Results == JAX reference; launches {paths[-1]}; requirement table {table}")

    cold = []
    for r in range(runs + 1):
        reset_bucket_highwater()
        gpu = GPUSolver(dev, stage_times=True)  # a fresh solver: a cold hybrid solve
        snap.pods = base
        split: dict = {}
        random.seed(0)
        with table_clock(split):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = gpu.solve(snap)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        expect(gpu.last_solve_mode == "hybrid" and not res.pod_errors, f"timed wide hybrid: mode {gpu.last_solve_mode}")
        cold.append((ms, {**gpu.last_stages, **split}))
    cold_ms = statistics.median(x[0] for x in cold[1:])
    keys = list(dict.fromkeys(k for x in cold for k in x[1]))
    stages = {k: statistics.median(x[1].get(k, 0.0) for x in cold[1:]) for k in keys}
    print(f"time wide hybrid snapshot to NodeClaims, cold hybrid solve {WIDE_SHAPE[0]}x{WIDE_SHAPE[1]} (fresh solver): "
          f"median of {runs} warm runs {cold_ms:.3f} ms (runs ms: {[round(x[0], 3) for x in cold]}; stages ms: "
          + ", ".join(f"{k} {x:.3f}" for k, x in stages.items()) + f") on {card}")

    threshold = nodeclaim.NATIVE_MIN_TABLE_ROWS
    arms: dict = {"table": [], "algebra": []}
    first: dict = {}
    filters: dict = {}
    snap.pods = base
    try:
        for r in range(runs + 1):
            for arm in ("table", "algebra") if r % 2 == 0 else ("algebra", "table"):
                nodeclaim.NATIVE_MIN_TABLE_ROWS = threshold if arm == "table" else n_types + 1
                random.seed(0)
                native.reset_counts()
                t0 = time.perf_counter()
                res = FFDSolver().solve(snap)
                arms[arm].append((time.perf_counter() - t0) * 1e3)
                filters[arm] = native.COUNTS["filters"]
                if arm not in first:
                    first[arm] = json_form(canonical_results(res))
    finally:
        nodeclaim.NATIVE_MIN_TABLE_ROWS = threshold
    expect(first["table"] == first["algebra"], "FFDSolver: the table's Results differ from the algebra's")
    expect(filters["table"] > 0 and filters["algebra"] == 0, f"FFDSolver: table filter calls {filters}")
    ffd = {arm: statistics.median(v[1:]) for arm, v in arms.items()}
    print(f"time FFDSolver.solve {WIDE_SHAPE[0]}x{WIDE_SHAPE[1]} (host only, alternated): with the requirement table "
          f"median of {runs} warm runs {ffd['table']:.3f} ms (runs ms: {[round(x, 3) for x in arms['table']]}; "
          f"{filters['table']} filter calls a solve), with the Python algebra {ffd['algebra']:.3f} ms (runs ms: "
          f"{[round(x, 3) for x in arms['algebra']]}); Results equal; on {card}")
    return dict(paths=paths, table=tables, ms=cold_ms, stages=stages, ffd_ms=ffd,
                ffd_runs={k: [round(x, 3) for x in v] for k, v in arms.items()}, ffd_filters=filters["table"])


# -- the DRA phase: a provisioning solve with claim-bearing pods -------------------------
DRA_FIXTURE = FIXTURES / "snapshot" / "headline_5000x100_dra_results.json"
DRA_STEPS = ("D0 cold", "D1 one pod", "D2 provision")
DRA_LAUNCHES = (  # kernels each DRA step must launch, once each (every other kernel: none)
    ("feasibility", "pack_scan", "sparsify"),  # D0: the masked problem packed in full
    ("feasibility", "pack_scan", "sparsify"),  # D1: the one pod packed from the masked carry
    ("feasibility", "pack_scan", "sparsify"),  # D2: the pass's cold hybrid solve
)


def dra_snapshot(build_snapshot=None, names=None, kube=None, resources=None):
    """The DRA headline (`testing/scenarios.add_dra` over the seeded
    headline: 256 of its plain pods hold device claims, 16 of its instance
    types carry template GPUs) and the one plain pod D1 appends. The
    arguments are `seeded_snapshot`'s and `add_dra`'s (the port's builders
    and object model by default; the fixture's writer passes the
    reference's)."""
    from karpenter_tpu_torch.testing.scenarios import add_dra

    snap, _added, one = seeded_snapshot(SNAPSHOT_SEED, build_snapshot, names)
    add_dra(snap, kube=kube, resources=resources)
    return snap, one


@contextmanager
def kept_allocators(module=None):
    """Keep every DRA `Allocator` built while it lasts (the residual
    scheduler's), in a list it yields. `module` is the allocator module
    (the port's by default)."""
    if module is None:
        import karpenter_tpu_torch.scheduling.dynamicresources.allocator as module
    kept: list = []
    real = module.Allocator.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        kept.append(self)

    module.Allocator.__init__ = init
    try:
        yield kept
    finally:
        module.Allocator.__init__ = real


@contextmanager
def allocator_clock(split: dict, key: str = "allocator"):
    """Add the wall ms of the port's DRA allocator (its construction, every
    allocation, superposition and commit, nested calls counted once) into
    `split[key]` while it lasts."""
    import karpenter_tpu_torch.scheduling.dynamicresources.allocator as alloc

    names = ("__init__", "allocate", "commit", "superpose_template_allocation", "commit_template_metadata",
             "release_instance_types", "template_devices")
    real = {n: getattr(alloc.Allocator, n) for n in names}
    depth = [0]

    def timed(fn):
        def call(*args, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    split[key] = split.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return call

    for n, fn in real.items():
        setattr(alloc.Allocator, n, timed(fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(alloc.Allocator, n, fn)


def dra_provisioner(snap, solver, kube=None, resources=None, provisioning=None, fake=None):
    """A `Provisioner` with the DynamicResources gate on over `snap`'s store
    (its pods created pending), a `FakeCloudProvider` of the headline's
    instance types with `dra_gpu_types` applied, and `solver`. The modules
    are the port's by default."""
    from karpenter_tpu_torch.testing.scenarios import dra_gpu_types

    if provisioning is None:
        import karpenter_tpu_torch.controllers.provisioning.provisioner as provisioning
    if fake is None:
        import karpenter_tpu_torch.cloudprovider.fake as fake
    pending_store(snap)
    types = fake.instance_types_assorted(SNAPSHOT_SHAPE[1])
    dra_gpu_types(types, kube, resources)
    return provisioning.Provisioner(snap.store, snap.cluster, fake.FakeCloudProvider(types), snap.clock, solver=solver,
                                    options=provisioning.ProvisionerOptions(dynamic_resources_enabled=True))


def check_dra(dev, card: str, errs: dict, runs: int = 5) -> dict:
    """The DRA phase: the DRA headline (`dra_snapshot`) solved by
    `GPUSolver().solve(snap)` cold (D0) and with one plain pod appended
    (D1), then one `Provisioner.reconcile(force=True)` with the
    DynamicResources gate on over a store holding its pods pending (D2),
    the counts set to 0 just before each step and read just after. Each
    step's canonical `Results`, mode, backend, fallback reasons and the
    residual allocator's committed allocations and claim metadata
    (`testing.canonical.canonical_allocation`), and D2's NodeClaims in the
    store, must equal the JAX reference's (`DRA_FIXTURE`), with the
    launches of `DRA_LAUNCHES`; each pack is run again on its kept inputs
    against its plain version. No step may fall back to the host unless the
    reference's does. Then it times a cold DRA solve on a fresh solver,
    median of `runs` warm runs, by stage (device synchronised after each),
    with the allocator's share of the residual."""
    import itertools
    import random

    import torch

    from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.testing.canonical import (canonical_allocation, canonical_node_claims, canonical_results,
                                                       json_form)

    stored = json.loads(DRA_FIXTURE.read_text())
    expect(stored["seed"] == SNAPSHOT_SEED, f"the DRA fixture was written for seed {stored['seed']}, not {SNAPSHOT_SEED}")
    paths = []

    def step(i, solve, store=None):
        want = stored["steps"][i]
        what = f"dra {DRA_STEPS[i]}"
        expect(want["step"] == DRA_STEPS[i], f"{what}: the fixture's step is {want['step']}")
        random.seed(0)
        nodeclaim._hostname_seq = itertools.count(1)
        seen: dict = {"pack": [], "rc": []}
        with kept_snapshot_inputs(seen), kept_allocators() as allocs:
            build.reset_launches()
            results, solver = solve()
            counts = dict(build.LAUNCHES)
        backend = {"gpu": "tpu"}.get(solver.last_backend, solver.last_backend)
        got = dict(mode=solver.last_solve_mode, backend=backend, reasons=list(solver.last_fallback_reasons))
        for key, value in got.items():
            expect(value == want[key], f"{what}: {key} {value!r}, the JAX reference's {want[key]!r}")
        expect(json_form(canonical_results(results)) == want["results"], f"{what}: Results differ from the JAX reference's")
        alloc = json_form([canonical_allocation(a) for a in allocs])
        expect(alloc == want["allocations"], f"{what}: the DRA allocations differ from the JAX reference's")
        if store is not None:
            expect(json_form(canonical_node_claims(store)) == want["claims"],
                   f"{what}: the NodeClaims in the store differ from the JAX reference's")
        expect(want["mode"] != "fallback" or solver.last_solve_mode == "fallback", f"{what}: fell back")
        need = {k: int(k in DRA_LAUNCHES[i]) for k in counts}
        expect(counts == need, f"{what}: launches {counts}, not {need}")
        expect(len(seen["pack"]) == 1 and not seen["rc"], f"{what}: {len(seen['pack'])} packs, {len(seen['rc'])} recredits")
        check_snapshot_kernels(seen, what, errs)
        paths.append({k: v for k, v in counts.items() if v})
        n_meta = sum(len(a[1]) for a in alloc)
        print(f"{what} ({len(results.new_node_claims)} claims, {len(results.pod_errors)} pod errors): mode "
              f"{solver.last_solve_mode}, backend {solver.last_backend}, {len(solver.last_fallback_reasons)} fallback "
              f"reasons, {len(allocs)} allocator(s), {n_meta} claims' template metadata; Results and allocations == JAX "
              f"reference; launches {paths[-1]}")

    snap, one = dra_snapshot()
    base = list(snap.pods)
    reset_bucket_highwater()
    solver = GPUSolver(dev)
    step(0, lambda: (solver.solve(snap), solver))
    snap.pods = base + [one]
    step(1, lambda: (solver.solve(snap), solver))
    psnap, _one = dra_snapshot()
    reset_bucket_highwater()
    gpu = GPUSolver(dev)
    prov = dra_provisioner(psnap, gpu)
    step(2, lambda: (prov.reconcile(force=True), gpu), store=psnap.store)

    snap.pods = base
    times, stages = [], []
    for r in range(runs + 1):
        reset_bucket_highwater()
        gpu = GPUSolver(dev, stage_times=True)  # a fresh solver: a cold DRA solve
        split: dict = {}
        with allocator_clock(split):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = gpu.solve(snap)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        expect(gpu.last_solve_mode == "hybrid" and not res.pod_errors, f"timed DRA solve: mode {gpu.last_solve_mode}")
        stages.append({**gpu.last_stages, "allocator (within residual)": split.get("allocator", 0.0)})
    ms = statistics.median(times[1:])
    med = {k: statistics.median(x.get(k, 0.0) for x in stages[1:]) for k in stages[-1]}
    print(f"time DRA snapshot to NodeClaims, cold DRA solve {SNAPSHOT_SHAPE[0]}x{SNAPSHOT_SHAPE[1]} (256 claim-bearing "
          f"pods, fresh solver): median of {runs} warm runs {ms:.3f} ms (runs ms: {[round(x, 3) for x in times]}; "
          f"stages ms: " + ", ".join(f"{k} {x:.3f}" for k, x in med.items()) + f") on {card}")
    return dict(paths=paths, ms=ms, stages=med)


# -- the operator phase: whole controller rounds of the operator's Environment ----------
OPERATOR_FIXTURE = FIXTURES / "operator" / "headline_5000x100_ticks.json"
OPERATOR_MAX_TICKS = 8  # the fixture's ticks at most (it ends at the first tick that changes nothing)
# the ticks the whole run drives (provisioning, binding, two consolidation
# rounds); `--only operator` drives every tick of the fixture
OPERATOR_RUN_TICKS = 4
OPERATOR_STEP = 2.0  # clock seconds before each tick
OPERATOR_SEED = 0  # `random`'s seed before the first tick (the NodeClaims' name suffixes)
OPERATOR_SPLIT = (("provisioner", "provisioner", "reconcile"), ("binder", "binder", "bind_all"),
                  ("lifecycle", "lifecycle", "reconcile_all"), ("disruption", "disruption", "reconcile"))
TIMED_NOTES = frozenset({"event_batch"})  # trace notes whose values are wall times


def operator_env(snap, environment, options, **kwargs):
    """An operator `Environment` (the default `FakeClock`) over a seeded
    snapshot: the snapshot's nodepool in its store, its instance types
    behind the KWOK provider, its pods created pending. `environment` and
    `options` are the package's `Environment` class and an `Options`."""
    np_ = snap.node_pools[0]
    env = environment(options=options, instance_types=snap.instance_types[np_.metadata.name], **kwargs)
    env.store.create(np_)
    for pod in snap.pods:
        env.store.create(pod)
    return env


def operator_start(nodeclaim) -> None:
    """The module state the ticks start from: `random` seeded (claim names)
    and the hostname placeholders of `nodeclaim` (the package's scheduling
    nodeclaim module) counted from 1."""
    import itertools
    import random

    random.seed(OPERATOR_SEED)
    nodeclaim._hostname_seq = itertools.count(1)


def solve_view(tr) -> dict:
    """A solve's trace as the fixture keeps it: mode, backend (the port's
    "gpu" read as the reference's "tpu"), pods, signatures, fallback
    reasons and notes (wall times left out)."""
    from karpenter_tpu_torch.testing.canonical import json_form

    return json_form(dict(mode=tr.mode, backend={"gpu": "tpu"}.get(tr.backend, tr.backend), n_pods=tr.n_pods,
                          n_sigs=tr.n_sigs, reasons=list(tr.fallback_reasons),
                          notes={k: v for k, v in tr.attribution.items() if k not in TIMED_NOTES}))


def operator_launches(solves: list) -> dict:
    """The kernels a tick's solves launch, from their traces: K1-K3 once per
    pack (a trace noting `pack_items`: full, masked and simulation solves;
    or a delta noting added pods), K4 once per delta that removes pods, K5
    and K6 once per LP decision (a `consolidate` trace noting its
    proposals)."""
    packs = sum(1 for s in solves if "pack_items" in s["notes"] or s["notes"].get("delta_added", 0) > 0)
    recredits = sum(1 for s in solves if s["notes"].get("delta_removed", 0) > 0)
    lp = sum(1 for s in solves if s["mode"] == "consolidate" and "proposals" in s["notes"])
    need = {"feasibility": packs, "pack_scan": packs, "sparsify": packs, "recredit": recredits,
            "globalpack": lp, "score_subsets": lp}
    return {k: v for k, v in need.items() if v}


class OperatorWatch:
    """Steps an `Environment`'s clock and ticks it, keeping per tick what
    the fixture records: the canonical state's digest, the NodeClaims,
    Nodes and bound pods, the solves its trace recorder saw, and each
    disruption method's commands (reason, candidates, replacements and a
    digest of the whole `canonical_command`)."""

    def __init__(self, env):
        self.env = env
        self.recorder = env.trace_recorder
        self.seq = self.recorder.seq
        self.decisions: list = []
        for method in env.disruption.methods:
            method.compute_commands = self._watched(method.compute_commands, type(method).__name__)

    def _watched(self, real, name: str):
        from karpenter_tpu_torch.testing.canonical import canonical_command, json_form

        def compute_commands(candidates, budgets):
            cmds = real(candidates, budgets)
            for cmd in cmds:
                full = json_form(canonical_command(cmd))
                self.decisions.append([name, full[0], full[1], len(full[2]), digest(full)])
            return cmds

        return compute_commands

    def tick(self) -> tuple:
        """One clock step and one `tick(provision_force=True)`: (the
        canonical state, the tick's record)."""
        from karpenter_tpu_torch.testing.canonical import canonical_operator, json_form

        env = self.env
        env.clock.step(OPERATOR_STEP)
        self.decisions = []
        env.tick(provision_force=True)
        traces = [tr for tr in self.recorder.traces() if tr.seq > self.seq]
        expect(len(traces) == self.recorder.seq - self.seq, "the trace ring dropped a solve of the tick")
        self.seq = self.recorder.seq
        state = json_form(canonical_operator(env))
        pods = env.store.list("Pod")
        return state, dict(digest=digest(state), claims=env.store.count("NodeClaim"), nodes=env.store.count("Node"),
                           bound=sum(1 for p in pods if p.spec.node_name), pods=len(pods),
                           solves=[solve_view(tr) for tr in traces], decisions=self.decisions)


def digest(x) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(x).encode()).hexdigest()


def operator_ticks(watch: OperatorWatch, max_ticks: int, quiet: int = 1) -> tuple[list, list]:
    """Tick until `quiet` ticks in a row change nothing (or `max_ticks`):
    the ticks' records (each with `changed`) and the last canonical state."""
    from karpenter_tpu_torch.testing.canonical import canonical_operator, json_form

    prev = json_form(canonical_operator(watch.env))
    records, state, still = [], prev, 0
    for _ in range(max_ticks):
        state, rec = watch.tick()
        rec["changed"] = state != prev
        records.append(rec)
        prev = state
        still = 0 if rec["changed"] else still + 1
        if still == quiet:
            break
    return records, state


def moved(x, dev):
    """`x` with every tensor it holds (in tuples, lists, dicts and the port's
    dataclasses, nested) moved to `dev`."""
    import copy

    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if type(x) in (tuple, list):
        return type(x)(moved(v, dev) for v in x)
    if type(x) is dict:
        return {k: moved(v, dev) for k, v in x.items()}
    if type(x).__module__.startswith("karpenter_tpu_torch.") and hasattr(x, "__dict__"):
        y = copy.copy(x)
        for k, v in vars(x).items():
            setattr(y, k, moved(v, dev))
        return y
    return x


ERR_KEYS = ("feasibility", "pack_scan", "sparsify", "recredit", "globalpack", "score_subsets")


def plain_worker(root: str, dev: str, jobs, results) -> None:
    """`plain_reruns` in a process of its own, on `dev` (`PlainWorker`):
    each message is a pickled (what, jobs) with the tensors on the host; the
    answer per message is (what, errs, the failure or None). None ends it."""
    import pickle

    sys.path.insert(0, root)
    while True:
        msg = jobs.get()
        if msg is None:
            return
        what, batch = pickle.loads(msg)
        errs = dict.fromkeys(ERR_KEYS, 0.0)
        try:
            plain_reruns(moved(batch, dev), what, errs)
            results.put((what, errs, None))
        except Exception as e:  # noqa: BLE001 - the parent fails with it
            results.put((what, errs, f"{type(e).__name__}: {e}"))


class PlainWorker:
    """The plain half of the kept calls' re-runs (`plain_reruns`), in a
    second process on the card, so that it runs beside the next ticks: the
    parent runs each kernel again itself (`kernel_reruns`) and sends the
    jobs over. `finish` waits for every answer and fails on the first
    failure; the process is always stopped."""

    def __init__(self, dev):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.jobs, self.results = ctx.Queue(), ctx.Queue()
        self.proc = ctx.Process(target=plain_worker, args=(str(ROOT), str(dev), self.jobs, self.results), daemon=True)
        self.proc.start()
        self.sent = 0

    def submit(self, what: str, jobs: list) -> None:
        import pickle

        self.jobs.put(pickle.dumps((what, moved(jobs, "cpu"))))
        self.sent += 1

    def finish(self, errs: dict, timeout: float = 600.0) -> None:
        import queue

        self.jobs.put(None)
        deadline = time.perf_counter() + timeout
        failures = []
        for _ in range(self.sent):
            while True:
                try:
                    what, got, failure = self.results.get(timeout=5.0)
                    break
                except queue.Empty:
                    expect(self.proc.is_alive(), f"the plain re-runs' process ended (exit code {self.proc.exitcode})")
                    expect(time.perf_counter() < deadline, "the plain re-runs' process gave no answer in time")
            for k, v in got.items():
                errs[k] = max(errs.get(k, 0.0), v)
            if failure is not None:
                failures.append(f"{what}: {failure}")
        expect(not failures, "; ".join(failures))

    def close(self) -> None:
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)


def check_operator(dev, card: str, errs: dict, max_ticks: int | None = None) -> dict:
    """The operator phase: the seeded headline's nodepool, 100 instance types
    and 5000 pending pods in an `Environment(Options())` with no device (so
    its `GPUSolver` is on the card), ticked once per tick of
    `OPERATOR_FIXTURE` (its first `max_ticks`, when given) after a 2 s clock
    step. Each tick's canonical state (NodeClaims, Nodes, each pod's node,
    events, counters) has the JAX reference's digest, its solves the
    reference's modes and notes, its disruption decisions the reference's
    commands; after the fixture's last tick the state equals the reference's
    in full. The counts are set to 0 before each tick
    and read after: they follow the recorded solves (`operator_launches`),
    and each kept pack, recredit, K5 and K6 call is run again against its
    plain version, the plain half in a second process on the card
    (`PlainWorker`) beside the next ticks. Once, no median: each tick's wall
    ms, split into the provisioner, binder, lifecycle, disruption and the
    rest."""
    import torch

    from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.obs import trace
    from karpenter_tpu_torch.operator import Environment
    from karpenter_tpu_torch.operator.options import Options

    want = json.loads(OPERATOR_FIXTURE.read_text())
    expect(want["shape"] == list(SNAPSHOT_SHAPE) and want["seed"] == SNAPSHOT_SEED, "operator fixture: another cluster")
    trace._DEFAULT = trace.TraceRecorder()
    reset_bucket_highwater()
    snap, _added, _one = seeded_snapshot()
    env = operator_env(snap, Environment, Options())
    solver = env.provisioner.solver
    expect(type(solver).__name__ == "GPUSolver" and solver.device.type == "cuda",
           f"operator: the provisioner's solver is {type(solver).__name__} on {getattr(solver, 'device', None)}")
    split: dict = {}

    def timed(name: str, obj, attr: str):
        real = getattr(obj, attr)

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                split[name] = split.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

        setattr(obj, attr, call)

    for name, owner, attr in OPERATOR_SPLIT:
        timed(name, getattr(env, owner), attr)
    watch = OperatorWatch(env)
    operator_start(nodeclaim)
    ticks, totals, state = [], {}, None
    worker = PlainWorker(dev)
    try:
        for k, w in enumerate(want["ticks"][:max_ticks]):
            what = f"operator tick {k}"
            seen: dict = {"pack": [], "rc": [], "k5": [], "k6": []}
            split.clear()
            with kept_snapshot_inputs(seen), kept_proposer_inputs(seen):
                build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, rec = watch.tick()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                counts = {n: c for n, c in build.LAUNCHES.items() if c}
            for key in ("claims", "nodes", "bound", "pods", "solves", "decisions", "digest"):
                expect(rec[key] == w[key],
                       f"{what}: {key} {str(rec[key])[:300]}, the JAX reference's {str(w[key])[:300]}")
            need = operator_launches(w["solves"])
            expect(counts == need, f"{what}: launches {counts}, the recorded solves need {need}")
            kept = {"pack_scan": len(seen["pack"]), "recredit": len(seen["rc"]), "globalpack": len(seen["k5"]),
                    "score_subsets": len(seen["k6"])}
            expect(all(v == need.get(k, 0) for k, v in kept.items()), f"{what}: kept calls {kept} for {need}")
            t1 = time.perf_counter()
            worker.submit(what, kernel_reruns(seen, what))
            del seen
            rerun_s = time.perf_counter() - t1
            for n, c in counts.items():
                totals[n] = totals.get(n, 0) + c
            tick_split = {n: round(split.get(n, 0.0), 3) for n, _o, _a in OPERATOR_SPLIT}
            tick_split["rest"] = round(wall - sum(tick_split.values()), 3)
            modes = [s["mode"] for s in rec["solves"]]
            ticks.append(dict(ms=round(wall, 3), split=tick_split, launches=counts, modes=modes))
            print(f"{what}: {wall:.3f} ms (" + ", ".join(f"{n} {v:.3f}" for n, v in tick_split.items())
                  + f") on {card}; {rec['claims']} NodeClaims, {rec['nodes']} Nodes, {rec['bound']} of {rec['pods']} pods "
                  f"bound, solves {modes}, {len(rec['decisions'])} disruption commands, launches {counts}; digest == JAX "
                  f"reference; kept calls' kernels == the path's ({rerun_s:.1f} s)")
        t1 = time.perf_counter()
        worker.finish(errs)
        print(f"operator: every kept call == plain on the card (the plain re-runs' process ended "
              f"{time.perf_counter() - t1:.1f} s after the last tick)")
    finally:
        worker.close()
    if len(ticks) == len(want["ticks"]):
        expect(state == want["final"], "operator: the last tick's state differs from the JAX reference's")
    return dict(ticks=ticks, launches=totals)


# -- the serving phase: churn, the fleet, the shard router, the entry point ------------

SERVING_FIXTURE = FIXTURES / "serving" / "churn_5000x100.json"
SERVING_CONCURRENT_S = 1.5  # the concurrent segment's wall seconds (worker=True)
SERVING_SHARDS = 2
SERVING_TICK_S = 0.5  # the entry point's controller round
PACK_KERNELS = ("feasibility", "pack_scan", "sparsify")


@contextmanager
def kept_serving_calls(seen: dict):
    """Keep the first full pack, the first delta pack (`_pack_flat` from a
    carry), the first recredit (K4) and every K5 and K6 call, in
    `kept_snapshot_inputs`' and `kept_proposer_inputs`' formats."""
    import karpenter_tpu_torch.kernels.recredit as k4
    import karpenter_tpu_torch.models.scheduler_model_grouped as grouped

    real_k4, real_pack = k4.recredit, grouped._pack_flat

    def recredit(state, t, *args):
        if seen["rc"]:
            return real_k4(state, t, *args)
        kept = clone_carry(state)
        out = real_k4(state, t, *args)
        seen["rc"].append((kept, t, args, out))
        return out

    def pack_flat(t, items, nnz_cap, init_state=None):
        kind = "pack" if init_state is None else "delta"
        if seen[kind]:
            return real_pack(t, items, nnz_cap, init_state=init_state)
        kept = None if init_state is None else clone_carry(init_state)
        out = real_pack(t, items, nnz_cap, init_state=init_state)
        seen[kind].append((t, items, nnz_cap, kept, out))
        return out

    k4.recredit, grouped._pack_flat = recredit, pack_flat
    try:
        with kept_proposer_inputs(seen):
            yield
    finally:
        k4.recredit, grouped._pack_flat = real_k4, real_pack


def serving_solve_launches(trace, counts: dict) -> None:
    """A provisioning solve's launches as its trace says: a full solve K1-K3
    (twice each after the slot-cap retry) and no K4; a delta K1-K3 once
    each when it adds pods, none otherwise, and K4 at most once, only when
    it removes pods; nothing else."""
    a = trace.attribution
    k = [counts.get(n, 0) for n in PACK_KERNELS]
    other = {n: c for n, c in counts.items() if n not in PACK_KERNELS + ("recredit",) and c}
    what = f"serving solve {trace.seq} ({trace.mode}): launches {counts}"
    expect(not other, what)
    if trace.mode == "full":
        expect(k[0] == k[1] == k[2] in (1, 2) and not counts.get("recredit"), what)
    else:
        expect(trace.mode == "delta", what)
        expect(k == [1 if a.get("delta_added") else 0] * 3, what + f", {a.get('delta_added')} pods added")
        expect(counts.get("recredit", 0) <= (1 if a.get("delta_removed") else 0),
               what + f", {a.get('delta_removed')} pods removed")


def serving_entry(dev, card: str, args: list[str], paths: tuple) -> dict:
    """`python -m karpenter_tpu_torch` with `args` (`--port 0`; on `dev`,
    the card by default, named with `--device` when it is not the card) in
    a subprocess: after two controller rounds each of `paths` must answer
    200 (`/readyz` polled until it does), then SIGTERM must end it with
    exit code 0. Returns each path's wall ms and the start-up seconds."""
    import re
    import signal
    import urllib.error
    import urllib.request

    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "karpenter_tpu_torch", "--port", "0", "--health-probe-port", "0", "--tick-seconds",
           str(SERVING_TICK_S), *([] if dev.type == "cuda" else ["--device", str(dev)]), *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        port, seen = None, []
        while port is None:
            line = proc.stdout.readline()
            expect(bool(line), f"entry point {args}: ended before its 'up' line: {''.join(seen)[-2000:]}")
            seen.append(line)
            m = re.search(r" up: .*http=[^:]*:(\d+)", line)
            port = int(m.group(1)) if m else None
            expect(time.perf_counter() - t0 < 300, f"entry point {args}: no 'up' line in 300 s")
        out["up_s"] = round(time.perf_counter() - t0, 3)
        expect("solver=gpu" in seen[-1], f"entry point {args}: {seen[-1].strip()}")
        time.sleep(2 * SERVING_TICK_S + 0.2)
        for path in paths:
            deadline = time.perf_counter() + 120
            while True:
                t1 = time.perf_counter()
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                        code, body = r.status, r.read().decode()
                except urllib.error.HTTPError as e:
                    code, body = e.code, e.read().decode()
                if code == 200 or path != "/readyz" or time.perf_counter() > deadline:
                    break
                time.sleep(0.2)
            expect(code == 200, f"entry point {args}: {path} answered {code}: {body[:300]}")
            out[path] = dict(ms=round((time.perf_counter() - t1) * 1e3, 3), bytes=len(body))
            if path == "/debug/shards":
                shards = json.loads(body)["shards"]
                expect(len(shards) == SERVING_SHARDS and all(r["alive"] for r in shards.values()),
                       f"entry point {args}: /debug/shards {body[:300]}")
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
        expect(proc.returncode == 0, f"entry point {args}: exit code {proc.returncode} on SIGTERM: {rest[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out["s"] = round(time.perf_counter() - t0, 3)
    print(f"entry point python -m karpenter_tpu_torch {' '.join(args) or '(single cluster)'}: up in {out['up_s']} s, "
          + ", ".join(f"{p} 200 in {out[p]['ms']} ms" for p in paths) + f", exit 0 on SIGTERM ({out['s']} s) on {card}")
    return out


def check_serving(dev, card: str, errs: dict) -> dict:
    """The serving phase (ROADMAP Queue 1 item 8), against
    `SERVING_FIXTURE` (the JAX reference's runs of `testing/serving.py`'s
    scenarios on the CPU), with shape bucketing on as serving runs it:

    1. The headline churn (`HEADLINE`: 5000 base pods, 100 types, 800
       arrivals, 600 cancellations and 800 departures a cycle, a bind flush
       every 4 solves, 32 steady solves, seed 0, synchronous prestager) in a
       `ChurnHarness` whose `GPUSolver` is on the card: every solve's mode
       and the placement digest after every bind flush the reference's, the
       report's wall-clock-free fields its, no kernel-library load in the
       steady window; the counts set to 0 before and read after, each
       solve's launches as its trace says (`serving_solve_launches`), K1-K4
       launched. The first full pack, delta pack and recredit are run again
       against their plain versions (the plain half in `PlainWorker`).
       Then the first node (by name) is revoked and `repack_savings
       ("global")` must launch K5 and K6, equal the reference's savings and
       its kept K5 and K6 calls their plain versions. Then the concurrent
       segment (`SERVING_CONCURRENT_S`, the prestager's worker thread on):
       triggers coalesced, every store pod tracked, every pending pod
       placed after the drain.
    2. The fleet: `FLEET_TENANTS` tenants (1250 base pods each, rates / 40)
       on a `FleetFrontend` on the card, pumped without the serve thread,
       each recording its event log: each tenant's modes, digests and
       report the reference's.
    3. The shard router: `ShardRouter(n_shards=2, solver="gpu")`, its two
       workers on the card, the kernels' build directory shared: `run_all`
       replays each tenant's log to the fleet's final digest; one worker is
       killed and its tenants re-homed onto the other to the same digests;
       the library was built once (one line in the build directory's
       `builds.log`, the first writer's stamp there).
    4. `python -m karpenter_tpu_torch` on the card, single-cluster and
       `--fleet-shards 2 --fleet-tenants 4`: its routes, exit 0 on SIGTERM.

    Prints churn events/s, the solves' P50/P99 seconds (the flight record),
    the delta-hit rate, the end-to-end event latency P50/P99 and its
    dominant stage (podtrace), the base fleet's provisioning time and the
    bind flushes' share of it, and each sub-phase's wall time."""
    import tempfile

    import torch

    from karpenter_tpu_torch import metrics as m
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.obs import trace as trace_mod
    from karpenter_tpu_torch.serving import ShardRouter
    from karpenter_tpu_torch.testing import serving as sv

    want = json.loads(SERVING_FIXTURE.read_text())
    expect(want["headline"]["spec"] == sv.HEADLINE and want["fleet"]["spec"] == sv.FLEET,
           "serving fixture: another scenario")
    bucket = os.environ.get("KARPENTER_SOLVER_BUCKET")
    os.environ["KARPENTER_SOLVER_BUCKET"] = "1"  # the serving default (the fixture's)
    phases, out = {}, {}
    worker = PlainWorker(dev)
    os.makedirs(ROOT / "build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="serving-", dir=str(ROOT / "build"))
    try:
        # -- 1. the headline churn ------------------------------------------------------
        t0 = time.perf_counter()
        sv.fresh_state()
        trace_mod._DEFAULT = trace_mod.TraceRecorder()
        api = sv.port_api(dev)
        h = api.harness(sv.headline_spec(api)).build()
        solver = h.env.provisioner.solver
        expect(type(solver).__name__ == "GPUSolver" and solver.device.type == torch.device(dev).type,
               f"serving: the harness's solver is {type(solver).__name__} on {getattr(solver, 'device', None)}")
        per_solve, timers = [], {"base": 0.0, "base_bind": 0.0}
        real_solve, real_base, real_flush = solver.solve, h.provision_base_fleet, h.bind_flush
        in_base = [False]

        def solve(snap):
            before = dict(build.LAUNCHES)
            res = real_solve(snap)
            per_solve.append((solver.recorder.last(), {n: c - before[n] for n, c in build.LAUNCHES.items()
                                                        if c != before[n]}))
            return res

        def base_fleet():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            in_base[0] = True
            try:
                real_base()
            finally:
                in_base[0] = False
                timers["base"] += time.perf_counter() - t1

        def bind_flush():
            t1 = time.perf_counter()
            real_flush()
            if in_base[0]:
                timers["base_bind"] += time.perf_counter() - t1

        solver.solve, h.provision_base_fleet, h.bind_flush = solve, base_fleet, bind_flush
        seen = {"pack": [], "delta": [], "rc": [], "k5": [], "k6": []}
        try:
            with kept_serving_calls(seen):
                build.reset_launches()
                torch.cuda.synchronize()
                rec = sv.run_recorded(api, h)
                torch.cuda.synchronize()
                churn_counts = {n: c for n, c in build.LAUNCHES.items() if c}
            rep = rec.pop("_report")
            w = want["headline"]
            expect(rec["modes"] == w["modes"], f"serving: modes {rec['modes']}, the JAX reference's {w['modes']}")
            first = next((i for i, (a, b) in enumerate(zip(rec["digests"], w["digests"])) if a != b), None)
            expect(rec["digests"] == w["digests"], f"serving: bind flush {first}'s placement digest differs from the "
                   f"JAX reference's ({len(rec['digests'])} flushes, the reference's {len(w['digests'])})")
            expect(rec["report"] == w["report"], f"serving: report {rec['report']}, the JAX reference's {w['report']}")
            expect(rep.steady_recompiles == 0, f"serving: the steady window loaded the kernel library: {rep.recompiles}")
            expect(len(per_solve) == len(rec["modes"]), f"serving: {len(per_solve)} solves traced, {len(rec['modes'])} recorded")
            for tr, counts in per_solve:
                serving_solve_launches(tr, counts)
            expect(all(churn_counts.get(n, 0) > 0 for n in PACK_KERNELS + ("recredit",)),
                   f"serving: the churn launched {churn_counts}, not each of K1-K4")
            expect(seen["pack"] and seen["delta"] and seen["rc"], "serving: no full pack, delta pack or recredit kept")
            jobs = kernel_reruns({"pack": seen["pack"] + seen["delta"], "rc": seen["rc"]}, "serving churn")
            worker.submit("serving churn", jobs)
            del jobs
            phases["churn"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            with kept_serving_calls(seen):
                build.reset_launches()
                torch.cuda.synchronize()
                repack = sv.revoke_and_repack(api, h)
                torch.cuda.synchronize()
                repack_counts = {n: c for n, c in build.LAUNCHES.items() if c}
            expect(repack == w["repack"], f"serving: repack {repack}, the JAX reference's {w['repack']}")
            expect(repack_counts.get("globalpack", 0) >= 1 and repack_counts.get("score_subsets", 0) >= 1,
                   f"serving: the global repack launched {repack_counts}")
            worker.submit("serving repack", kernel_reruns({"k5": seen["k5"], "k6": seen["k6"]}, "serving repack"))
            phases["repack"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            coalesced0 = h.env.registry.counter(m.SOLVER_CHURN_COALESCED_TOTAL).total()
            h.loop.prestager.start()
            cev, csolves = h.run_concurrent(SERVING_CONCURRENT_S)
            coalesced = h.env.registry.counter(m.SOLVER_CHURN_COALESCED_TOTAL).total() - coalesced0
            pods = h.env.store.borrow_list("Pod")
            names = {p.metadata.name for p in pods}
            expect(cev > 0 and csolves > 0 and coalesced > 0,
                   f"serving concurrent: {cev} events, {csolves} solves, {coalesced} coalesced triggers")
            expect(names == set(h._pending) | set(h._bound), "serving concurrent: the store's pods are not the tracked ones")
            expect(not h._pending and all(p.spec.node_name for p in pods),
                   f"serving concurrent: {len(h._pending)} pods left pending after the drain")
            phases["concurrent"] = time.perf_counter() - t1
        finally:
            solver.solve = real_solve
            h.close()
        out["churn"] = dict(report={k: v for k, v in rep.as_dict().items() if k not in ("recompiles",)},
                            launches=churn_counts, repack=repack, repack_launches=repack_counts,
                            base_s=timers["base"], base_bind_s=timers["base_bind"],
                            concurrent=dict(events=cev, solves=csolves, coalesced=coalesced))
        print(f"serving churn {sv.HEADLINE['n_base_pods']}x{sv.HEADLINE['n_types']} on {card}: {rep.events} events in "
              f"{rep.wall_seconds:.3f} s = {rep.events_per_sec:.1f} events/s; solve P50 {rep.p50_solve_seconds:.6f} s, "
              f"P99 {rep.p99_solve_seconds:.6f} s (flight record, {rep.solves} steady solves); delta-hit "
              f"{rep.delta_hit_rate}; end-to-end event P50 {rep.e2e_p50_seconds:.6f} s, P99 {rep.e2e_p99_seconds:.6f} s "
              f"over {rep.e2e_events} events, dominant stage {rep.dominant_stage} (stage P99 {rep.stage_p99_seconds}); "
              f"base fleet {timers['base']:.3f} s, bind flushes {timers['base_bind']:.3f} s of it "
              f"({100 * timers['base_bind'] / timers['base']:.1f}%); launches {churn_counts}; modes and "
              f"{len(rec['digests'])} digests == JAX reference")
        print(f"serving repack after revoking 1 node on {card}: savings {repack['savings']} $/h == JAX reference, "
              f"launches {repack_counts} ({phases['repack']:.3f} s); concurrent segment {SERVING_CONCURRENT_S} s "
              f"(prestager worker on): {cev} events, {csolves} solves, {coalesced:.0f} coalesced triggers, 0 pending")

        # -- 2. the fleet ----------------------------------------------------------------
        t1 = time.perf_counter()
        sv.fresh_state()
        fleet = api.fleet()
        try:
            build.reset_launches()
            tenants = sv.run_fleet(api, fleet, log_dir=tmp)
            torch.cuda.synchronize()
            fleet_counts = {n: c for n, c in build.LAUNCHES.items() if c}
            finals = {tid: api.placement_digest(s.env) for tid, s in fleet.sessions().items()}
        finally:
            fleet.close()
        for tid, r in tenants.items():
            r.pop("_report")
            wt = want["fleet"]["tenants"][tid]
            for key in ("modes", "digests", "report"):
                expect(r[key] == wt[key], f"serving fleet {tid}: {key} {str(r[key])[:300]}, the JAX reference's "
                       f"{str(wt[key])[:300]}")
            expect(finals[tid] == wt["digests"][-1], f"serving fleet {tid}: the final state is not the last flush's")
        expect(all(fleet_counts.get(n, 0) > 0 for n in PACK_KERNELS), f"serving fleet: launches {fleet_counts}")
        phases["fleet"] = time.perf_counter() - t1
        out["fleet"] = dict(launches=fleet_counts, events=sum(r["report"]["events"] for r in tenants.values()))
        print(f"serving fleet {sv.FLEET_TENANTS} tenants x {sv.FLEET['n_base_pods']} pods on {card}: every tenant's "
              f"modes, digests and report == JAX reference; launches {fleet_counts} ({phases['fleet']:.3f} s)")

        # -- 3. the shard router -----------------------------------------------------------
        t1 = time.perf_counter()
        lib_dir = Path(build.lib()._name).parent
        router = ShardRouter(n_shards=SERVING_SHARDS, solver="gpu", cache_dir=str(build.BUILD_DIR), device=str(dev))
        try:
            expect(router.spawn() == [f"shard-{i}" for i in range(SERVING_SHARDS)], "serving shards: spawn")
            for tid in finals:
                router.add_tenant(tid, log_path=os.path.join(tmp, f"{tid}.jsonl"))
            results = router.run_all()
            expect(all(r.get("ok") for r in results.values()), f"serving shards: run_all {str(results)[:500]}")
            digests = {tid: router._tenants[tid]["digest"] for tid in finals}
            expect(digests == finals, f"serving shards: replayed digests {digests}, the fleet's {finals}")
            owners = router.tenants()
            victim = owners[min(owners)]
            expect(len(set(owners.values())) == SERVING_SHARDS, f"serving shards: the tenants' owners {owners}")
            router._handle(victim).kill()
            expect(router.check_shards()[victim] == "quarantined", "serving shards: the killed worker's breaker")
            rehomed = router.rehome_tenants(victim)
            orphans = sorted(t for t, s in owners.items() if s == victim)
            expect(sorted(rehomed) == orphans and all(r["matches"] for r in rehomed.values()),
                   f"serving shards: re-homed {rehomed}")
            expect(all(router._tenants[t]["digest"] == finals[t] for t in orphans), "serving shards: re-homed digests")
        finally:
            router.close()
        builds = (lib_dir / "builds.log").read_text().splitlines() if (lib_dir / "builds.log").exists() else []
        expect(len(builds) == 1, f"serving shards: the kernel library was built {len(builds)} times: {builds}")
        expect((build.BUILD_DIR / ".karpenter-cache-stamp").exists(), "serving shards: no first writer's stamp")
        phases["shards"] = time.perf_counter() - t1
        out["shards"] = dict(owners=owners, rehomed=sorted(rehomed), builds=builds)
        print(f"serving shards on {card}: {SERVING_SHARDS} workers replayed {len(finals)} tenants to the fleet's "
              f"digests, {victim} killed and its tenants {orphans} re-homed to the same digests; the kernel library "
              f"built once ({builds[0]}) ({phases['shards']:.3f} s)")

        # -- 4. the entry point ----------------------------------------------------------
        t1 = time.perf_counter()
        out["entry"] = serving_entry(dev, card, [], ("/readyz", "/metrics", "/debug/solves"))
        out["entry_sharded"] = serving_entry(dev, card, ["--fleet-shards", str(SERVING_SHARDS), "--fleet-tenants", "4"],
                                             ("/readyz", "/metrics", "/debug/tenants", "/debug/shards"))
        phases["entry"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        worker.finish(errs)
        print(f"serving: every kept call == plain on the card (the plain re-runs ended {time.perf_counter() - t1:.1f} s "
              f"after the entry point)")
    finally:
        worker.close()
        if bucket is None:
            os.environ.pop("KARPENTER_SOLVER_BUCKET", None)
        else:
            os.environ["KARPENTER_SOLVER_BUCKET"] = bucket
    out["phases_s"] = {k: round(v, 3) for k, v in phases.items()}
    print("serving sub-phases s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + f" on {card}")
    return out


# -- the meshed phase: the slot-sharded pack on a mesh of one card's shards ------------

MESH_SIZES = (2, 4, 8)  # shards of the sharded K2 held to K2 (the headline, both existing fleets)
MESH_PLAIN_SIZES = (3, 5)  # shards of the sharded K2 held to the plain multi-shard arm (slot axes padded)
# shard counts past one warp's lanes (the exchange reduces over the shards in
# strides of 32): held to K2 at the headline and both existing fleets, timed
# at the headline (33 on a padded slot axis), and the meshed solve's first
# step at 33. The plain arm (a thread per shard, ~10 / ~25 s here on the small
# snapshot) meets them in `tests/test_torch_cuda.py` and, at 33, against the
# reference in `tests/test_torch_sharded.py`.
MESH_WIDE_SIZES = (33, 64)
MESH_SOLVE_SHARDS = 4  # the meshed GPUSolver's mesh: four shards of the card


def mesh_small_snapshot():
    """`tests/test_sharded.py`'s zone-spread + hostname anti-affinity
    workload (6 db pods spread and anti-affine by hostname, 17 web pods
    spread with skew 2, 9 plain pods) over the port's object model."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.cloudprovider import catalog
    from karpenter_tpu_torch.kube import Store
    from karpenter_tpu_torch.solver.snapshot import SolverSnapshot
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.state.informer import start_informers
    from karpenter_tpu_torch.testing import scenarios as sc
    from karpenter_tpu_torch.utils.clock import FakeClock

    db, web = {"matchLabels": {"app": "db"}}, {"matchLabels": {"app": "web"}}
    pods = ([sc.make_pod(cpu="500m", labels={"app": "db"}, tsc=[sc.zone_spread(1, db)],
                         anti_affinity=[sc.hostname_anti_affinity(db)]) for _ in range(6)]
            + [sc.make_pod(cpu="1", labels={"app": "web"}, tsc=[sc.zone_spread(2, web)]) for _ in range(17)]
            + [sc.make_pod(cpu="2", memory="4Gi") for _ in range(9)])
    store, clock = Store(), FakeClock()
    cluster = Cluster(store, clock)
    start_informers(store, cluster)
    pool = sc.make_nodepool(requirements=[{"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
                                          {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]}])
    store.create(pool)
    return SolverSnapshot(store=store, cluster=cluster, node_pools=[pool],
                          instance_types={pool.metadata.name: catalog.construct_instance_types()},
                          state_nodes=cluster.nodes(), daemonset_pods=[], pods=pods, clock=clock)


def sharded_leaves(takes, left, shards) -> list:
    """(name, tensor) of a slot-sharded scan's outputs: takes, leftovers and
    every leaf of every shard's carry."""
    out = [("takes", takes), ("leftovers", left)]
    for s, carry in enumerate(shards):
        out += [(f"shard {s} {leaf}", x) for leaf, x in zip(STATE_LEAVES, carry_leaves(carry))]
    return out


def expect_same_leaves(got: list, want: list, what: str) -> float:
    import torch

    expect([n for n, _ in got] == [n for n, _ in want], f"{what}: outputs differ in kind")
    for (name, a), (_n, b) in zip(got, want):
        expect(a.shape == b.shape and torch.equal(a, b), f"{what}: {name} differs")
    return max_abs(*[(a, b) for (_n, a), (_m, b) in zip(got, want)])


def mesh_launches(launched: tuple, full: bool, shards: int, form: str) -> dict:
    """The launches of a solve step on the meshed solver: a step's full pack
    (K1 -> K2 -> K3, `launched` as on one device) runs K1 once per shard and
    the sharded K2 in `form` ("cluster": `pack_scan_cluster`, "grid":
    `pack_scan_sharded`); its delta packs and recredits are the
    single-device path's."""
    need = {k: int(k in launched)
            for k in ("feasibility", "pack_scan", "pack_scan_sharded", "pack_scan_cluster", "sparsify", "recredit")}
    if full:
        need.update(feasibility=shards, pack_scan=0, pack_scan_sharded=int(form == "grid"),
                    pack_scan_cluster=int(form == "cluster"))
    return need


def check_mesh_steps(dev, what: str, fixture, steps, launches, full_steps, pods_of, force: bool,
                     shards: int = MESH_SOLVE_SHARDS, form: str = "cluster") -> list:
    """`GPUSolver(mesh=make_mesh([dev] * shards)).solve(snap)` over `steps`
    (the pods of step i from `pods_of(i, pods, solver)`), the
    counts set to 0 just before each step and read just after: each step's
    canonical Results, mode, backend and reasons equal to the reference's
    (`fixture`, which the unmeshed solver also meets), with the launches of
    `mesh_launches` (the sharded K2 in `form`, which the full steps' state
    must name); no step may fall back to the host (`force`: none may
    try)."""
    import random

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.parallel.sharded import make_mesh
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.testing.canonical import canonical_results, json_form

    stored = json.loads(fixture.read_text())
    expect(stored["seed"] == SNAPSHOT_SEED, f"{what}: the fixture was written for seed {stored['seed']}")
    reset_bucket_highwater()
    solver = GPUSolver(dev, force=force, mesh=make_mesh([dev] * shards))
    paths = []
    snap = None
    for i, (step, want, launched) in enumerate(zip(steps, stored["steps"], launches)):
        expect(want["step"] == step, f"{what} {step}: the fixture's step is {want['step']}")
        snap = pods_of(i, snap, solver)
        random.seed(0)
        build.reset_launches()
        results = solver.solve(snap)
        counts = {k: v for k, v in build.LAUNCHES.items() if v}
        expect(solver.last_solve_mode != "fallback", f"{what} {step}: the solve fell back to the host")
        backend = {"gpu": "tpu"}.get(solver.last_backend, solver.last_backend)
        got = dict(mode=solver.last_solve_mode, backend=backend, reject=solver.last_delta_reject,
                   reasons=list(solver.last_fallback_reasons))
        for key, value in got.items():
            expect(value == want[key], f"{what} {step}: {key} {value!r}, the JAX reference's {want[key]!r}")
        expect(json_form(canonical_results(results)) == want["results"], f"{what} {step}: Results differ")
        need = {k: v for k, v in mesh_launches(launched, step in full_steps, shards, form).items() if v}
        expect(counts == need, f"{what} {step}: launches {counts}, not {need}")
        if step in full_steps:
            ran = solver._resident["state"].exchange
            expect(ran == form, f"{what} {step}: the sharded K2 ran in the {ran} form, not the {form} form")
        paths.append(counts)
        print(f"meshed {what} {step} ({len(snap.pods)} pods, {shards} shards): mode "
              f"{solver.last_solve_mode}, {len(results.new_node_claims)} claims, Results == JAX reference; "
              f"launches {counts}")
    return paths


def sharded_rows(sharded: dict, errs: dict) -> list:
    """The sharded K2's entries of the `kernels` line, one per form: the
    cluster form at MESH_SOLVE_SHARDS shards, the grid form at
    MESH_SOLVE_SHARDS too (its launches from the meshed solve at 33), each
    with its time per shard count and its exchanges per solve."""
    rows = []
    for form, name in (("cluster", "pack_scan_cluster"), ("grid", "pack_scan_sharded")):
        r = sharded[form]
        row = kernel_row(r["row"], {name: r["launches"]}, errs)
        row.update(shards=MESH_SOLVE_SHARDS, ms_per_shards=r["ms_per_shards"], k2_same_run_ms=sharded["k2_ms"],
                   exchanges=r["exchanges"], us_per_exchange=r["us_per_exchange"])
        if form == "cluster":
            row.update(largest_cluster=sharded["largest"], fleets_ms=sharded["fleets_ms"])
        rows.append(row)
    return rows


def sharded_forms(t, items, compat, key, S: int) -> dict:
    """Each form of the sharded K2 on the padded `t` at S shards: form ->
    (takes, leftovers, shards' carries, barrier); the cluster form only
    where the card places it."""
    from karpenter_tpu_torch.kernels import pack_scan as kps

    out = {"grid": kps.pack_scan_sharded_grid(t, items, compat, key, n_slots=t.n_slots, n_shards=S)}
    if kps.exchange_form(S, kps.largest_cluster(t, items, n_slots=t.n_slots, n_shards=S)) == "cluster":
        out["cluster"] = kps.pack_scan_sharded_cluster(t, items, compat, key, n_slots=t.n_slots, n_shards=S)
    return out


def expect_forms_equal(forms: dict, want: list, S: int, what: str, errs: dict) -> dict:
    """Each form's takes, leftovers and gathered carry against `want`
    (K2's), bit for bit; returns form -> exchanges."""
    from karpenter_tpu_torch.kernels import pack_scan as kps
    from karpenter_tpu_torch.parallel import sharded as sh

    n_x = {}
    for form, (takes, left, shards, barrier) in forms.items():
        state = sh.ShardedState(sh.make_mesh([takes.device] * S), shards, barrier, form)
        got = [("takes", takes), ("leftovers", left)] + list(zip(STATE_LEAVES, carry_leaves(state.gather_state())))
        name = kps.FORMS[form]
        errs[name] = max(errs[name], expect_same_leaves(got, want, f"{what} {form} form S={S}"))
        n_x[form] = int(barrier) // S
    expect(len(set(n_x.values())) == 1, f"{what} S={S}: the forms' exchange counts differ: {n_x}")
    return n_x


def check_sharded(dev, card: str, errs: dict) -> dict:
    """The meshed phase. The slot-sharded K2 in both forms (the cluster
    form, `pack_scan_cluster`, and the grid form, `pack_scan_sharded`)
    against the plain multi-shard arm on `mesh_small_snapshot` at
    `MESH_PLAIN_SIZES` shards, against K2 at the headline and both existing
    fleets at `MESH_SIZES` (takes, leftovers, every shard's carry), and K1
    per shard (`sharded_feasibility`) against K1, bit for bit; the form the
    chooser picks at each S is the cluster form there. Then the meshed solve
    over the seeded headline's `SOLVE_STEPS` and the hybrid headline's
    `HYBRID_STEPS` (`check_mesh_steps`, the cluster form), `anneal_sharded`
    against K7 on one device over the same keys and `sharded_compat_matrix`
    against K1 over the headline's pods. At `MESH_WIDE_SIZES` (33, 64)
    shards it holds the grid form (the chooser's pick there) to K2 at the
    headline and both fleets, and runs the seeded headline's first solve
    step on a mesh of 33. Then it times both forms per shard count at the
    headline (CUDA events, median; 33 on a padded slot axis; the cluster
    form also at the largest cluster the card places), K2 in the same run
    before and after, and the plain arm once."""
    import torch

    from karpenter_tpu_torch.kernels.anneal import anneal
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, feasibility, feasibility_plain
    from karpenter_tpu_torch.kernels import pack_scan as kps
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import make_tensors, reset_bucket_highwater
    from karpenter_tpu_torch.models.scheduler_model_grouped import build_items, initial_state, make_item_tensors
    from karpenter_tpu_torch.models.shard_exchange import pack_scan_sharded_plain
    from karpenter_tpu_torch.parallel import sharded as sh
    from karpenter_tpu_torch.solver.consolidation import tensors_from_problem
    from karpenter_tpu_torch.solver.encode import encode
    from karpenter_tpu_torch.solver.encoded import from_reference, load_npz
    from karpenter_tpu_torch.utils.prng import chain_streams, prng_key, split

    t1 = time.perf_counter()
    reset_bucket_highwater()
    problem = from_reference(encode(mesh_small_snapshot()))
    arrays, _pods = build_items(problem)
    items = make_item_tensors(arrays, dev)
    t0 = make_tensors(problem, dev)
    for S in MESH_PLAIN_SIZES:
        what = f"sharded K2 small S={S}"
        mesh = sh.make_mesh([dev] * S)
        t = sh.pad_slots_for_mesh(t0, mesh)
        compat, key = sh.sharded_feasibility(t, items, mesh)
        compat_p, key_p = feasibility_plain(t, items)
        torch.cuda.synchronize()
        expect(torch.equal(compat, compat_p) and same_bits(key, key_p), f"{what}: K1 per shard differs from plain")
        *_out, chosen = kps.pack_scan_sharded(t, items, compat, key, n_slots=t.n_slots, n_shards=S)
        expect(chosen == "cluster", f"{what}: the chooser picked the {chosen} form")
        forms = sharded_forms(t, items, compat, key, S)
        plain_out = pack_scan_sharded_plain(t, items, compat_p, key_p, n_slots=t.n_slots, n_shards=S)
        plain = sharded_leaves(*plain_out[:3])
        torch.cuda.synchronize()
        n_x = {}
        for form, out in forms.items():
            name = kps.FORMS[form]
            errs[name] = max(errs[name], expect_same_leaves(sharded_leaves(*out[:3]), plain, f"{what} {form} form"))
            n_x[form] = int(out[3]) // S
        expect(n_x.get("cluster") == n_x["grid"], f"{what}: exchanges {n_x}")
        print(f"{what} (N {t0.n_slots} -> {t.n_slots}, W {items.item_req.shape[0]}): the chooser picks the {chosen} "
              f"form; cluster and grid forms == plain multi-shard arm, exchanges {n_x} (plain arm "
              f"{int(plain_out[3]) // S}), leftovers {int(plain_out[1].sum())}")

    exchanges = {"cluster": {}, "grid": {}}
    largest = {}
    for name in (HEADLINE, FLEET, FLEET_BIG):
        _p, _r, t0, items, _nnz = prepare(name, dev)
        compat, key = feasibility(t0, items)
        picked = {}
        for S in MESH_SIZES + MESH_WIDE_SIZES:
            what = f"sharded K2 {name}"
            mesh = sh.make_mesh([dev] * S)
            t = sh.pad_slots_for_mesh(t0, mesh)
            c_s, k_s = sh.sharded_feasibility(t, items, mesh)
            takes, left, state = sh.pack_scan_sharded(t, items, c_s, k_s, mesh)
            picked[S] = state.exchange
            expect(state.exchange == ("grid" if S in MESH_WIDE_SIZES else "cluster"),
                   f"{what} S={S}: the chooser picked the {state.exchange} form")
            takes1, left1, one = pack_scan(t, items, compat, key, n_slots=t.n_slots)
            torch.cuda.synchronize()
            expect(torch.equal(c_s, compat) and same_bits(k_s, key), f"{what} S={S}: K1 per shard differs from K1")
            want = [("takes", takes1), ("leftovers", left1)] + list(zip(STATE_LEAVES, carry_leaves(one)))
            forms = {state.exchange: (takes, left, state.shards, state.barrier)}
            if S in MESH_SIZES:
                forms["grid"] = kps.pack_scan_sharded_grid(t, items, compat, key, n_slots=t.n_slots, n_shards=S)
            for form, n in expect_forms_equal(forms, want, S, what, errs).items():
                exchanges[form][(name, S)] = n
            if name == HEADLINE:
                largest[S] = kps.largest_cluster(t, items, n_slots=t.n_slots, n_shards=S)
        print(f"sharded K2 == K2 at {name} (N {t0.n_slots}, W {items.item_req.shape[0]}, open {int(one[6])}): "
              + ", ".join(f"S={S} picks {picked[S]}, exchanges " + "/".join(
                  f"{f} {exchanges[f][(name, S)]}" for f in ("cluster", "grid") if (name, S) in exchanges[f])
                  for S in MESH_SIZES + MESH_WIDE_SIZES))
    print(f"largest cluster the card places at {HEADLINE}'s shape: "
          + ", ".join(f"S={S} {v}" for S, v in largest.items()))

    # every small fixture (the host-affinity probe among them), and one
    # whose items request nothing: a fitting open slot then holds 2^30 pods,
    # K2's closed form for the take total fails, and such place() calls
    # exchange their take total (gsum)
    for name in sorted(p.stem for p in FIXTURES.glob("small_*.npz")):
        _p, _r, t0, items0, _nnz = prepare(name, dev)
        variants = [("", items0)]
        if name == "small_existing_affinity":
            variants.append((" zero requests", replace(items0, item_req=torch.zeros_like(items0.item_req))))
        for label, items in variants:
            compat, key = feasibility(t0, items)
            n_x = {}
            for S in MESH_PLAIN_SIZES:
                mesh = sh.make_mesh([dev] * S)
                t = sh.pad_slots_for_mesh(t0, mesh)
                takes1, left1, one = pack_scan(t, items, compat, key, n_slots=t.n_slots)
                forms = sharded_forms(t, items, compat, key, S)
                expect("cluster" in forms, f"sharded K2 {name}{label} S={S}: no cluster form")
                torch.cuda.synchronize()
                want = [("takes", takes1), ("leftovers", left1)] + list(zip(STATE_LEAVES, carry_leaves(one)))
                n_x[S] = expect_forms_equal(forms, want, S, f"sharded K2 {name}{label}", errs)["grid"]
            print(f"sharded K2 (cluster and grid forms) == K2 at {name}{label} (N {t0.n_slots}) for S in "
                  f"{MESH_PLAIN_SIZES}: exchanges {n_x}, {place_calls(t0, items)} place() calls")

    # past the axis caps (bit sets of several words, tables in the global
    # spill): the other builds of the kernel, on padded slot axes
    for name in CAPS_PACKS:
        problem, ref = load_npz(CAPS / f"{name}.npz")
        reset_bucket_highwater()
        arrays, _pods = build_items(problem)
        items = make_item_tensors(arrays, dev)
        t0 = make_tensors(problem, dev, n_slots=int(ref["ref_n_slots"]))
        compat, key = feasibility(t0, items)
        for S in MESH_PLAIN_SIZES:
            mesh = sh.make_mesh([dev] * S)
            t = sh.pad_slots_for_mesh(t0, mesh)
            takes1, left1, one = pack_scan(t, items, compat, key, n_slots=t.n_slots)
            forms = sharded_forms(t, items, compat, key, S)
            expect("cluster" in forms, f"sharded K2 {name} S={S}: no cluster form")
            torch.cuda.synchronize()
            want = [("takes", takes1), ("leftovers", left1)] + list(zip(STATE_LEAVES, carry_leaves(one)))
            expect_forms_equal(forms, want, S, f"sharded K2 {name}", errs)
        print(f"sharded K2 (cluster and grid forms) == K2 at {name} (N {t0.n_slots}, D {t0.counts_dom_init.shape[1]}, "
              f"G {t0.counts_dom_init.shape[0]}, R {items.item_req.shape[1]}) for S in {MESH_PLAIN_SIZES}")

    snap, added, one_pod = seeded_snapshot()
    base = list(snap.pods)
    solve_pods = solve_step_pods(base, added, one_pod)

    def solve_step(i, _prev, _solver):
        snap.pods = solve_pods[i]
        return snap

    solve_paths = check_mesh_steps(dev, "solve", SOLVE_FIXTURE, SOLVE_STEPS, SOLVE_LAUNCHES, ("step 0",), solve_step,
                                   force=True)
    wide_paths = check_mesh_steps(dev, "solve", SOLVE_FIXTURE, SOLVE_STEPS[:1], SOLVE_LAUNCHES[:1], ("step 0",),
                                  solve_step, force=True, shards=MESH_WIDE_SIZES[0], form="grid")
    hsnap, _added, hone = seeded_snapshot(fallback_frac=HYBRID_FALLBACK_FRAC)
    hpods = [list(hsnap.pods)]

    def hybrid_step(i, _prev, solver):
        hpods.append(hybrid_step_pods(i, hpods[-1], hone, solver.encode_cache.last_enc))
        hsnap.pods = hpods[-1]
        return hsnap

    hybrid_paths = check_mesh_steps(dev, "hybrid", HYBRID_FIXTURE, HYBRID_STEPS, HYBRID_LAUNCHES,
                                    ("H0 cold", "H3 removal"), hybrid_step, force=False)

    problem, _ref = cons_load(CONS_ANNEAL)
    ct, _aux = tensors_from_problem(problem, dev, dense_compat=True)
    mesh = sh.make_mesh([dev] * MESH_SOLVE_SHARDS)
    key7 = prng_key(7)
    build.reset_launches()
    bx, bs = sh.anneal_sharded(ct, key7, mesh, n_chains=64, n_steps=512)
    anneal_counts = {k: v for k, v in build.LAUNCHES.items() if v}
    x0, flips, u = (torch.from_numpy(a).to(dev) for a in chain_streams(split(key7, 64), 512, ct.node_price.shape[0]))
    bx1, bs1 = anneal(ct, x0, flips, u)
    torch.cuda.synchronize()
    expect(torch.equal(bx, bx1) and torch.equal(bs, bs1), "anneal_sharded differs from K7 on one device")
    expect(anneal_counts == {"anneal_pack": MESH_SOLVE_SHARDS, "anneal": MESH_SOLVE_SHARDS},
           f"anneal_sharded launches {anneal_counts}")
    from karpenter_tpu_torch.models.scheduler_model import make_pod_tensors

    hp, _hr, ht, _hi, _hn = prepare(HEADLINE, dev)
    pods = make_pod_tensors(hp, dev, ht)
    compat_s = sh.sharded_compat_matrix(ht, pods, mesh)
    compat_1 = compat_and_key(ht, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)[0]
    torch.cuda.synchronize()
    expect(torch.equal(compat_s, compat_1), "sharded_compat_matrix differs from K1 over the pods")
    print(f"anneal_sharded ({MESH_SOLVE_SHARDS} shards, 64 chains x 512 steps, {CONS_ANNEAL}) == K7 on one device, "
          f"launches {anneal_counts}; sharded_compat_matrix ({hp.n_pods} pods) == K1")

    # times at the headline: both forms per shard count (the cluster form
    # also at the largest cluster the card places, if that is past
    # MESH_SIZES), K2 in the same run before and after, the plain arm
    problem, _ref, t0, items, _nnz = prepare(HEADLINE, dev)
    compat, key = feasibility(t0, items)
    N = t0.n_slots
    k2_ms = [cuda_ms(lambda: pack_scan(t0, items, compat, key, n_slots=N), 3)]
    top = max(largest[S] for S in MESH_SIZES)
    cluster_sizes = MESH_SIZES + ((top,) if top not in MESH_SIZES else ())
    padded = {S: sh.pad_slots_for_mesh(t0, sh.make_mesh([dev] * S)) for S in MESH_SIZES + MESH_WIDE_SIZES}
    padded.update({S: sh.pad_slots_for_mesh(t0, sh.make_mesh([dev] * S)) for S in cluster_sizes})
    wrappers = {"grid": kps.pack_scan_sharded_grid, "cluster": kps.pack_scan_sharded_cluster}
    ms = {"grid": {}, "cluster": {}}
    for S in sorted(set(MESH_SIZES + MESH_WIDE_SIZES + cluster_sizes)):
        tS = padded[S]
        for form in ("grid", "cluster"):
            if S in (cluster_sizes if form == "cluster" else MESH_SIZES + MESH_WIDE_SIZES):
                ms[form][S] = cuda_ms(lambda f=wrappers[form], tS=tS, S=S: f(tS, items, compat, key,
                                                                               n_slots=tS.n_slots, n_shards=S), 3)
    for S in cluster_sizes:
        if S not in MESH_SIZES:
            tS = padded[S]
            out = sharded_forms(tS, items, compat, key, S)
            expect("cluster" in out, f"the cluster form does not place at its largest size S={S}")
            takes1, left1, one = pack_scan(tS, items, compat, key, n_slots=tS.n_slots)
            torch.cuda.synchronize()
            want = [("takes", takes1), ("leftovers", left1)] + list(zip(STATE_LEAVES, carry_leaves(one)))
            for form, n in expect_forms_equal(out, want, S, f"sharded K2 {HEADLINE}", errs).items():
                exchanges[form][(HEADLINE, S)] = n
    k2_ms.append(cuda_ms(lambda: pack_scan(t0, items, compat, key, n_slots=N), 3))
    S = MESH_SOLVE_SHARDS
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    takes_p, left_p, _shards_p, _barrier_p = pack_scan_sharded_plain(t0, items, compat, key, n_slots=N, n_shards=S)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    for form, f in wrappers.items():
        takes, left, _shards, _barrier = f(t0, items, compat, key, n_slots=N, n_shards=S)
        torch.cuda.synchronize()
        expect(torch.equal(takes, takes_p) and torch.equal(left, left_p),
               f"sharded K2 ({form} form) at the headline differs from plain")
    n_bytes, ops = k2_cost(t0, items, compat, key, initial_state(t0, N), takes, left)
    R = items.item_req.shape[1]
    nw = 1  # words of a domain mask at the headline (D = 5)
    xs = exchanges["grid"]
    # the grid form's exchanges through L2: each shard writes its part and
    # reads all S, per exchange; the cluster form's stay in shared memory
    x_bytes = {s_: xs[(HEADLINE, s_)] * s_ * (1 + s_) * 4 * max(2, nw) + xs[(HEADLINE, s_)] * s_ * 8
               for s_ in MESH_SIZES + MESH_WIDE_SIZES}
    calls = place_calls(t0, items)
    k2_med = statistics.median(k2_ms)
    per_x = {f: {s_: (ms[f][s_] - k2_med) * 1e3 / exchanges[f][(HEADLINE, s_)] for s_ in ms[f]} for f in ms}
    for form in ("cluster", "grid"):
        print(f"time sharded K2, {form} form, at {HEADLINE} (CUDA events, median of 5 x 3): " + ", ".join(
            f"S={s_} {ms[form][s_]:.4f} ms (N {padded[s_].n_slots}, {exchanges[form][(HEADLINE, s_)]} exchanges, "
            f"{per_x[form][s_]:.3f} us per exchange beyond K2)" for s_ in sorted(ms[form]))
            + f" on {card}")
    print(f"time K2 at {HEADLINE} in the same run, before / after: {k2_ms[0]:.4f} / {k2_ms[1]:.4f} ms ({calls} "
          f"place() calls, {k2_med * 1e3 / calls:.2f} us each); the plain multi-shard arm at S={S} {plain_ms:.1f} ms "
          f"(one call) on {card} (R={R}, {time.perf_counter() - t1:.1f} s phase)")
    # both fleets: hundreds of open slots per shard, where the split shortens
    # each shard's slot loops
    fleets = {}
    for name in (FLEET, FLEET_BIG):
        _p, _r, tf, itf, _nnz = prepare(name, dev)
        cf, kf = feasibility(tf, itf)
        row = {"K2": cuda_ms(lambda: pack_scan(tf, itf, cf, kf, n_slots=tf.n_slots), 3)}
        for S_ in MESH_SIZES:
            tS = sh.pad_slots_for_mesh(tf, sh.make_mesh([dev] * S_))
            for form in ("cluster", "grid"):
                row[f"{form} S={S_}"] = cuda_ms(lambda f=wrappers[form], tS=tS, S_=S_: f(
                    tS, itf, cf, kf, n_slots=tS.n_slots, n_shards=S_), 3)
        fleets[name] = row
        print(f"time at {name} (N {tf.n_slots}, CUDA events, median of 5 x 3): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()) + f" on {card}")
    fastest = min(ms["cluster"], key=ms["cluster"].get)
    print(f"the cluster form {'beats' if ms['cluster'][fastest] < k2_med else 'does not beat'} K2 at {HEADLINE}: "
          f"fastest at S={fastest} {ms['cluster'][fastest]:.4f} ms against K2 {k2_med:.4f} ms; at S={S} "
          f"{ms['cluster'][S]:.4f} ms against the grid form's {ms['grid'][S]:.4f} ms")

    def form_out(form: str, launches: int, extra_bytes: int) -> dict:
        row = dict(name=kps.FORMS[form], ms=ms[form][S], plain_ms=plain_ms, library_ms=None,
                   bytes=n_bytes + extra_bytes, ops=ops)
        return dict(row=row, launches=launches, ms_per_shards={str(s_): v for s_, v in ms[form].items()},
                    exchanges={f"{n}/{s_}": v for (n, s_), v in exchanges[form].items()},
                    us_per_exchange={str(s_): v for s_, v in per_x[form].items()})

    return dict(cluster=form_out("cluster", solve_paths[0].get("pack_scan_cluster", 0), 0),
                grid=form_out("grid", wide_paths[0].get("pack_scan_sharded", 0), x_bytes[S]),
                k2_ms=k2_med, largest={str(s_): v for s_, v in largest.items()}, fleets_ms=fleets,
                paths={"solve": solve_paths, "solve_33": wide_paths, "hybrid": hybrid_paths, "anneal": anneal_counts})


class GCClock:
    """Wall ms inside the cyclic collector, and collections by generation,
    while installed."""

    def __init__(self):
        self.ms = 0.0
        self.counts = [0, 0, 0]
        self._t0 = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.counts[info["generation"]] += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


CONS_FLEET_FIXTURE = FIXTURES / "consolidation" / "fleet_5000_lp_command.json"
CONS_FLEET_NODES = 5000  # the reference's 5000-node target (bench_consolidation_lp)
CONS_ROUND_SEED = 0  # `random`'s seed before the round and the pass (the fixture's)


@contextmanager
def kept_proposer_inputs(seen: dict):
    """Keep the inputs and outputs of every K5 (`globalpack`) and K6
    (`score_subsets_packed`) call the path makes, in `seen["k5"]` and
    `seen["k6"]`."""
    import karpenter_tpu_torch.kernels.globalpack as k5
    import karpenter_tpu_torch.kernels.score_subsets as k6

    real_k5, real_k6 = k5.globalpack, k6.score_subsets_packed

    def globalpack(*args):
        out = real_k5(*args)
        seen["k5"].append((args, out))
        return out

    def score_subsets_packed(*args):
        out = real_k6(*args)
        seen["k6"].append((args, out))
        return out

    k5.globalpack, k6.score_subsets_packed = globalpack, score_subsets_packed
    try:
        yield
    finally:
        k5.globalpack, k6.score_subsets_packed = real_k5, real_k6


def check_proposer_inputs(seen: dict, what: str, errs: dict) -> None:
    """Each K5 and K6 call of a round, repeated on its kept inputs: K5 within
    D_TOL of its plain version (and equal to the round's own output), K6 bit
    for bit."""
    plain_reruns(kernel_reruns({k: seen[k] for k in ("k5", "k6")}, what), what, errs)


def consolidation_side(dev, n: int = CONS_FLEET_NODES):
    """The bench's consolidation fleet of `n` nodes, its provisioner
    (`GPUSolver` on `dev`) and disruption controller (`Options()`: the "gpu"
    backend) wired directly: (fleet, provisioner, controller)."""
    from karpenter_tpu_torch.controllers.disruption.controller import DisruptionController
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.testing.scenarios import build_consolidation_fleet

    fleet = build_consolidation_fleet(n)
    prov = Provisioner(fleet.store, fleet.cluster, fleet.cloud_provider, fleet.clock,
                       solver=GPUSolver(dev, stage_times=True))
    dc = DisruptionController(fleet.store, fleet.cluster, prov, fleet.cloud_provider, fleet.clock, Options())
    return fleet, prov, dc


def check_consolidation(dev, card: str, errs: dict, runs: int = 5) -> dict:
    """The consolidation phase (module docstring): one LP decision and one
    disruption pass over the 5000-node fleet against the JAX reference's,
    the kernels on the path held to their plain versions, then timed."""
    import random

    import torch

    from karpenter_tpu_torch.controllers.disruption import validation
    from karpenter_tpu_torch.controllers.disruption.methods import MultiNodeConsolidation
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.encode import clear_encode_globals
    from karpenter_tpu_torch.testing.canonical import canonical_command, canonical_node_claims, json_form

    want = json.loads(CONS_FLEET_FIXTURE.read_text())
    t0 = time.perf_counter()
    fleet, prov, dc = consolidation_side(dev)
    build_s = time.perf_counter() - t0
    ctx = dc.ctx

    def decision_round(stages: dict | None = None):
        t1 = time.perf_counter()
        with GCClock() as gcc:
            cands = dc.get_candidates()
        if stages is not None:
            stages["get_candidates"] = (time.perf_counter() - t1) * 1e3
            stages["gc (within get_candidates)"] = gcc.ms
        ctx.round_candidates = cands
        ctx.node_pool_totals = None
        m = MultiNodeConsolidation(ctx)
        return m, cands, m._lp_option(cands, fleet.clock.now() + 1e9)

    random.seed(CONS_ROUND_SEED)
    clear_encode_globals()
    reset_bucket_highwater()
    seen: dict = {"pack": [], "rc": [], "k5": [], "k6": []}
    with kept_snapshot_inputs(seen), kept_proposer_inputs(seen):
        build.reset_launches()
        m, cands, cmd = decision_round()
        counts = dict(build.LAUNCHES)
    what = f"consolidation decision ({CONS_FLEET_NODES} nodes)"
    got = dict(n_candidates=len(cands), command=json_form(canonical_command(cmd)),
               probes=[m.last_round["sim_masked"], m.last_round["sim_scratch"]])
    expect(got["n_candidates"] == want["decision"]["n_candidates"], f"{what}: {len(cands)} candidates")
    expect(got["probes"] == want["decision"]["probes"], f"{what}: probes {got['probes']}, the JAX reference's "
           f"{want['decision']['probes']}")
    expect(got["command"] == want["decision"]["command"], f"{what}: the Command differs from the JAX reference's")
    masked = got["probes"][0]
    need = {k: 0 for k in counts}
    need.update(globalpack=1, score_subsets=1, feasibility=len(seen["pack"]), pack_scan=len(seen["pack"]),
                sparsify=len(seen["pack"]))
    expect(counts == need and len(seen["pack"]) >= masked >= 1, f"{what}: launches {counts}, not {need}")
    check_proposer_inputs(seen, what, errs)
    check_snapshot_kernels(seen, what, errs)
    del seen
    round_counts = {k: v for k, v in counts.items() if v}
    cmd_size = len(got["command"][1])
    print(f"{what} (fleet built in {build_s:.2f} s): {cmd_size} of {len(cands)} candidates -> "
          f"{len(got['command'][2])} replacement, {m.last_round['proposals']} proposals, probes masked {masked} "
          f"scratch {got['probes'][1]}; Command == JAX reference; launches {round_counts}; K5, K6 and K1-K3 on "
          "their kept inputs == plain")
    check_round_trace(dev, card, prov, ctx, decision_round, want["decision"], got["command"])

    walls, stages = [], []
    for _ in range(runs + 1):
        st: dict = {}
        torch.cuda.synchronize()
        with GCClock() as gcc:
            t1 = time.perf_counter()
            m, _cands, cmd = decision_round(st)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        expect(json_form(canonical_command(cmd)) == got["command"], "a timed consolidation round gave another Command")
        stages.append({**st, **m.last_round["stages"], "gc (within the round)": gcc.ms})
    ms = statistics.median(walls[1:])
    med = {k: statistics.median(x.get(k, 0.0) for x in stages[1:]) for k in stages[-1]}
    print(f"time consolidation decision ({CONS_FLEET_NODES} nodes, MultiNodeConsolidation._lp_option): median of "
          f"{runs} warm rounds {ms:.3f} ms (runs ms: {[round(x, 3) for x in walls]}); stages ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in med.items()) + f" on {card}")

    split: dict = {}

    def timed(obj, name: str, key: str) -> None:
        real = getattr(obj, name)

        def call(*args, **kwargs):
            t1 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                split[key] = split.get(key, 0.0) + (time.perf_counter() - t1) * 1e3

        setattr(obj, name, call)

    real_sim = validation.simulate_scheduling
    timed(validation, "simulate_scheduling", "validator re-simulation")
    timed(dc.queue, "start_command", "start_command")
    random.seed(CONS_ROUND_SEED)
    clear_encode_globals()
    reset_bucket_highwater()
    seen = {"pack": [], "rc": [], "k5": [], "k6": []}
    now0 = fleet.clock.now()
    try:
        with kept_snapshot_inputs(seen), kept_proposer_inputs(seen), GCClock() as gcc:
            build.reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dc.reconcile(force=True)
            torch.cuda.synchronize()
            pass_ms = (time.perf_counter() - t1) * 1e3
            pass_counts = dict(build.LAUNCHES)
        split["gc (within the pass)"] = gcc.ms
    finally:
        validation.simulate_scheduling = real_sim
    what = f"disruption pass ({CONS_FLEET_NODES} nodes)"
    items = dc.queue._items
    tainted = sorted(n.metadata.name for n in fleet.store.list("Node")
                     if any(t.key.endswith("disrupted") for t in n.spec.taints))
    got_pass = dict(commands=[json_form(canonical_command(it.command)) for it in items], tainted=tainted,
                    claims=json_form(canonical_node_claims(fleet.store)), waited=fleet.clock.now() - now0)
    for key in ("commands", "tainted", "claims", "waited"):
        expect(got_pass[key] == want["pass"][key], f"{what}: {key} differ from the JAX reference's")
    need = {k: 0 for k in pass_counts}
    need.update(globalpack=1, score_subsets=1, feasibility=len(seen["pack"]), pack_scan=len(seen["pack"]),
                sparsify=len(seen["pack"]))
    expect(pass_counts == need and len(seen["pack"]) >= 2, f"{what}: launches {pass_counts}, not {need}")
    check_proposer_inputs(seen, what, errs)
    check_snapshot_kernels(seen, what, errs)
    del seen
    lp = dc.methods[3].last_round
    pass_path = {k: v for k, v in pass_counts.items() if v}
    print(f"{what}: started {len(items)} command of {len(got_pass['commands'][0][1])} candidates, "
          f"{len(tainted)} nodes tainted, {len(got_pass['claims'])} NodeClaims in the store, clock +{got_pass['waited']} s;"
          f" == JAX reference; launches {pass_path}; K5, K6 and K1-K3 on their kept inputs == plain")
    print(f"time disruption pass (DisruptionController.reconcile(force=True), {CONS_FLEET_NODES} nodes): {pass_ms:.3f} ms "
          "(pass ms: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f", LP decision stages: " + ", ".join(f"{k} {v:.3f}" for k, v in lp["stages"].items())
          + f"; probes masked {lp['sim_masked']} scratch {lp['sim_scratch']}) on {card}")
    return dict(round_counts=round_counts, pass_counts=pass_path, ms=ms, stages=med, pass_ms=pass_ms,
                pass_split=split, build_s=build_s, probes=got["probes"], command_size=cmd_size)


def check_round_trace(dev, card: str, prov, ctx, decision_round, want: dict, command) -> None:
    """The LP decision again with a metrics registry and an enabled trace
    recorder: the round's trace (mode "consolidate", backend "lp", the
    reference's spans `encode_candidates`, `lp_repack`, `round` and one
    `validate` per probe) and its counters equal to the reference's
    (`want["counters"]`: the proposal batch, the LP iterations, the
    validations, the savings gauge), K5 and K6 launched once under it."""
    import random

    from karpenter_tpu_torch import metrics as pm
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.obs.trace import TraceRecorder
    from karpenter_tpu_torch.solver.encode import clear_encode_globals
    from karpenter_tpu_torch.testing.canonical import canonical_command, json_form

    reg, rec = pm.make_registry(), TraceRecorder(enabled=True)
    solver = prov.solver
    old = solver.recorder
    ctx.metrics, solver.recorder = reg, rec
    random.seed(CONS_ROUND_SEED)
    clear_encode_globals()
    reset_bucket_highwater()
    try:
        build.reset_launches()
        m, _cands, cmd = decision_round()
        counts = dict(build.LAUNCHES)
    finally:
        ctx.metrics, solver.recorder = None, old
    what = f"traced consolidation decision ({CONS_FLEET_NODES} nodes)"
    expect(json_form(canonical_command(cmd)) == command, f"{what}: another Command")
    tr = m.round_trace
    expect(tr is not None and tr.mode == "consolidate" and tr.backend == "lp", f"{what}: no round trace")
    top = [sp.name for sp in tr.spans]
    expect(top[:3] == ["encode_candidates", "lp_repack", "round"] and set(top[3:]) == {"validate"},
           f"{what}: spans {top}")
    got = dict(proposals=reg.counter(pm.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).value(proposer="lp"),
               lp_iterations=reg.counter(pm.SOLVER_CONSOLIDATION_LP_ITERATIONS_TOTAL).total(),
               accepted=reg.counter(pm.SOLVER_CONSOLIDATION_VALIDATION_TOTAL).value(decision="accept"),
               rejected=reg.counter(pm.SOLVER_CONSOLIDATION_VALIDATION_TOTAL).value(decision="reject"),
               savings_per_hour=reg.gauge(pm.SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR).value(proposer="lp"))
    expect(got == want["counters"], f"{what}: counters {got}, the JAX reference's {want['counters']}")
    expect(counts["globalpack"] == 1 and counts["score_subsets"] == 1, f"{what}: launches {counts}")
    sims = [t for t in rec.traces() if t.mode == "sim"]
    expect(len(sims) == tr.attribution["sim_masked"] and all(t.backend == "gpu" for t in sims),
           f"{what}: {len(sims)} probe traces")
    breakdown = {k: v * 1e3 for k, v in tr.phase_totals.items()}
    print(f"{what}: trace spans {top}, counters {got} == JAX reference; {len(sims)} probe traces (mode sim); "
          "breakdown from the spans, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()) + f" on {card}")


# -- the consolidation arms: KARPENTER_CONSOLIDATE_LP =1, =0 and =anneal ----------
ARMS_FIXTURE = FIXTURES / "consolidation" / "fleet_128_arms.json"
ARMS_NODES = 128  # every node budget-eligible: the anneal arm's 100-candidate window is full (K7 at Np = 128)
ARMS = ("1", "0", "anneal")
# K5-K7's launches in each arm's pass (the probes' K1-K3 and K4 vary with the probes)
ARMS_LAUNCHES = {"1": dict(globalpack=1, score_subsets=1, anneal_pack=0, anneal=0),
                 "0": dict(globalpack=0, score_subsets=0, anneal_pack=0, anneal=0),
                 "anneal": dict(globalpack=0, score_subsets=0, anneal_pack=1, anneal=1)}
# the reference's exact arms of the host switches: the same Results as the defaults'
EXACT_ARMS = {"KARPENTER_FFD_BATCH": "0", "KARPENTER_ENCODE_COLUMNAR": "0", "KARPENTER_SOLVER_FASTDECODE": "0",
              "KARPENTER_SIM_SHARED_SCHED": "0"}


@contextmanager
def switched(env: dict):
    """The environment variables of `env` set while it lasts, then as they
    were."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def arms_side(dev, n: int = ARMS_NODES):
    """`consolidation_side` at `n` nodes, as the namespace `arm_pass` reads."""
    import types

    fleet, prov, dc = consolidation_side(dev, n)
    return types.SimpleNamespace(store=fleet.store, clock=fleet.clock, prov=prov, dc=dc)


def arm_pass(side, arm: str, env: dict | None = None, reset=None) -> dict:
    """One `DisruptionController.reconcile(force=True)` over `side` with
    `KARPENTER_CONSOLIDATE_LP=arm` (and `env`), from `random`'s
    `CONS_ROUND_SEED` and `reset()` (by default the port's encoder globals
    and bucket high-water marks cleared): the commands it started, the
    disrupted taints, the NodeClaims in the store, how far the clock moved.
    Duck-typed: the fixture's writer runs it over the reference's side."""
    import random

    from karpenter_tpu_torch.testing.canonical import canonical_command, canonical_node_claims, json_form

    if reset is None:
        from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
        from karpenter_tpu_torch.solver.encode import clear_encode_globals

        def reset():
            clear_encode_globals()
            reset_bucket_highwater()

    with switched({"KARPENTER_CONSOLIDATE_LP": arm, **(env or {})}):
        random.seed(CONS_ROUND_SEED)
        reset()
        t0 = side.clock.now()
        side.dc.reconcile(force=True)
    items = side.dc.queue._items
    tainted = sorted(n.metadata.name for n in side.store.list("Node")
                     if any(t.key.endswith("disrupted") for t in n.spec.taints))
    return dict(commands=[json_form(canonical_command(it.command)) for it in items], tainted=tainted,
                claims=json_form(canonical_node_claims(side.store)), waited=side.clock.now() - t0)


@contextmanager
def kept_anneal_inputs(seen: list):
    """Keep the inputs and outputs of every K7 call (`kernels.anneal.anneal`:
    the pre-pass and the chains) in `seen`."""
    import karpenter_tpu_torch.kernels.anneal as k7

    real = k7.anneal

    def anneal(t, x0, flips, u):
        out = real(t, x0, flips, u)
        seen.append(((t, x0, flips, u), out))
        return out

    k7.anneal = anneal
    try:
        yield
    finally:
        k7.anneal = real


def check_consolidate_arms(dev, card: str, errs: dict) -> dict:
    """The consolidation arms' phase (module docstring): one disruption pass
    per `KARPENTER_CONSOLIDATE_LP` arm over a fresh `ARMS_NODES`-node fleet,
    the counts set to 0 just before and read just after, each equal to the
    JAX reference's (`ARMS_FIXTURE`); K7's inputs on the anneal arm kept
    and the kernel held to its plain version on them; each arm's pass timed
    again on a fresh fleet; the LP arm and the seeded headline's solve steps
    again with the host switches at the reference's exact arms."""
    import random

    import torch

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.anneal import anneal as k7_launch
    from karpenter_tpu_torch.kernels.anneal import anneal_plain, anneal_prepass, anneal_prepass_plain
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.testing.canonical import canonical_results, json_form

    want = json.loads(ARMS_FIXTURE.read_text())
    expect(want["nodes"] == ARMS_NODES and want["seed"] == CONS_ROUND_SEED, "the arms fixture's fleet differs")
    out: dict = {}
    for arm in ARMS:
        what = f"consolidation pass, KARPENTER_CONSOLIDATE_LP={arm} ({ARMS_NODES} nodes)"
        side = arms_side(dev)
        seen: list = []
        with kept_anneal_inputs(seen):
            build.reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = arm_pass(side, arm)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            counts = dict(build.LAUNCHES)
        for key in ("commands", "tainted", "claims", "waited"):
            expect(got[key] == want["arms"][arm][key], f"{what}: {key} differ from the JAX reference's")
        need = ARMS_LAUNCHES[arm]
        expect({k: counts[k] for k in need} == need and counts["pack_scan"] >= 1,
               f"{what}: launches {counts}, K5-K7 not {need}")
        if arm == "anneal":
            expect(len(seen) == 1, f"{what}: {len(seen)} K7 calls")
            (t, x0, flips, u), (bx, bs) = seen[0]
            expect(t.node_price.shape[0] == 128, f"{what}: K7 at Np = {t.node_price.shape[0]}, not 128")
            bx_p, bs_p = anneal_plain(t, x0, flips, u)
            got_pre, want_pre = anneal_prepass(t, flips), anneal_prepass_plain(t, flips)
            torch.cuda.synchronize()
            errs["anneal"] = max(errs["anneal"], max_abs((bx, bx_p), (bs, bs_p)))
            errs["anneal_pack"] = max(errs["anneal_pack"], max_abs(*zip(got_pre[:3], want_pre)))
            expect(torch.equal(bx, bx_p) and torch.equal(bs, bs_p), f"{what}: K7 differs from plain on its inputs")
            expect(all(torch.equal(a, b) for a, b in zip(got_pre[:3], want_pre)) and int(got_pre[3].item()) == 0,
                   f"{what}: K7's pre-pass differs from plain on its inputs")
            bound, by = bound_of(*k7_cost(t, *flips.shape))
            k7 = dict(ms=cuda_ms(lambda: k7_launch(t, x0, flips, u), 5, rounds=3),
                      plain_ms=cuda_ms(lambda: anneal_plain(t, x0, flips, u), 1, rounds=2), bound_ms=bound,
                      bound_by=by, pack_ms=cuda_ms(lambda: anneal_prepass(t, flips), 20))
            print(f"time anneal on the pass's tensors (Np = {t.node_price.shape[0]}, C = {flips.shape[0]} chains x "
                  f"{flips.shape[1]} steps, Tp = {t.row_price.shape[0]}): {k7['ms']:.4f} ms kernel (pre-pass and "
                  f"chains), {k7['plain_ms']:.4f} ms plain, bound {bound:.5f} ms ({by}); the pre-pass alone "
                  f"{k7['pack_ms']:.4f} ms on {card}")
        cmd = got["commands"][0] if got["commands"] else None
        out[arm] = dict(launches={k: v for k, v in counts.items() if v}, ms=ms,
                        command_size=len(cmd[1]) if cmd else 0, **({"k7": k7} if arm == "anneal" else {}))
        print(f"{what}: started {len(got['commands'])} command of {out[arm]['command_size']} candidates, "
              f"{len(got['tainted'])} nodes tainted, {len(got['claims'])} NodeClaims, == JAX reference; launches "
              f"{out[arm]['launches']}" + ("; K7 and its pre-pass on the round's tensors == plain" if arm == "anneal"
                                           else "") + f"; {ms:.3f} ms (the first pass) on {card}")
    # the first passes above are each arm's first in the process (the first
    # arm's the process's first encode and probes): time each arm again on
    # a fresh fleet, with every arm warm
    for arm in ARMS:
        side = arms_side(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        again = arm_pass(side, arm)
        torch.cuda.synchronize()
        out[arm]["warm_ms"] = (time.perf_counter() - t1) * 1e3
        expect(again == want["arms"][arm], f"a second KARPENTER_CONSOLIDATE_LP={arm} pass differs from the JAX "
               "reference's")
        print(f"time disruption pass (DisruptionController.reconcile(force=True), KARPENTER_CONSOLIDATE_LP={arm}, "
              f"{ARMS_NODES} nodes, a fresh fleet, every arm warm): {out[arm]['warm_ms']:.3f} ms on {card}")

    what = f"consolidation pass, KARPENTER_CONSOLIDATE_LP=1 with {EXACT_ARMS} ({ARMS_NODES} nodes)"
    got = arm_pass(arms_side(dev), "1", EXACT_ARMS)
    for key in ("commands", "tainted", "claims", "waited"):
        expect(got[key] == want["arms"]["1"][key], f"{what}: {key} differ from the JAX reference's")
    print(f"{what}: == the default arms' (the JAX reference's)")

    stored = json.loads(SOLVE_FIXTURE.read_text())
    snap, added, one = seeded_snapshot()
    pods_of = solve_step_pods(list(snap.pods), added, one)
    reset_bucket_highwater()
    modes = []
    with switched(EXACT_ARMS):
        solver = GPUSolver(dev, force=True)
        for step, pods, ref in zip(SOLVE_STEPS, pods_of, stored["steps"]):
            snap.pods = pods
            random.seed(0)
            results = solver.solve(snap)
            backend = {"gpu": "tpu"}.get(solver.last_backend, solver.last_backend)
            got = dict(mode=solver.last_solve_mode, backend=backend, reject=solver.last_delta_reject,
                       reasons=list(solver.last_fallback_reasons))
            for key, value in got.items():
                expect(value == ref[key], f"solve {step} with {EXACT_ARMS}: {key} {value!r}, the default's "
                       f"{ref[key]!r}")
            expect(json_form(canonical_results(results)) == ref["results"],
                   f"solve {step} with {EXACT_ARMS}: Results differ from the default arms'")
            expect(solver._decode_memo is None, f"solve {step} with {EXACT_ARMS}: the decode memo was saved")
            modes.append(solver.last_solve_mode)
    print(f"seeded headline solve steps {list(SOLVE_STEPS)} with {EXACT_ARMS}: modes {modes}, Results == the "
          "default arms' (the JAX reference's)")
    return out


def k1_cost(t, items, compat, key) -> tuple[int, int]:
    """(bytes K1 must move, operations it must do): inputs read once,
    outputs written once; per (item, row) three operations for each key it
    tests (the keys no dom key forces, up to the first false one; none
    where the row's taint class is not tolerated), and 3R + 4 for the
    taint test and the key."""
    import torch

    from karpenter_tpu_torch.ops.bitset import test_bit

    W, R = items.item_req.shape
    Nrows, K = t.row_labels.shape
    k1_in = nbytes(t.row_labels, t.row_taint_class, t.row_alloc, t.row_pool_rank, items.item_mask,
                   items.item_taint_ok, items.item_req)
    tested = [k for k in range(K) if k not in set(t.dom_keys)]
    C = items.item_taint_ok.shape[1]
    tc = t.row_taint_class.long()
    taint = items.item_taint_ok[:, torch.clamp(torch.where(tc < 0, tc + C, tc), 0, C - 1)]
    tests = torch.zeros((W, Nrows), dtype=torch.int64, device=taint.device)
    if tested and W:
        masks = items.item_mask[:, None, tested, :].expand(W, Nrows, len(tested), items.item_mask.shape[2])
        ok = test_bit(masks, t.row_labels[None, :, tested].expand(W, Nrows, len(tested)))
        tests = torch.where(ok.all(dim=2), len(tested), ok.int().argmin(dim=2) + 1)
    n_tests = int(torch.where(taint, tests, 0).sum())
    return k1_in + nbytes(compat, key), 3 * n_tests + W * Nrows * (3 * R + 4)


# K1's own cases: name -> (seed, B, Nrows, K, Words, C, R, dom_keys). Every
# case has negative label ids (one under a forced key in every fifth row)
# and ids past the last word, taint classes out of range both ways (a
# negative one wraps once, as the reference's gather reads it), zero
# requests and two pad rows at -3.4e38, and its dom keys force K1's keys 0
# and K - 1 and hold -1 and K, which force nothing. "edges" has 21 mask
# words an item (copied a word at a time, not 16 bytes), "wide" K = 40 and
# Words = 2, "none" no items, "b70000" more items than the old grid's y axis
# held (65535), "rows_1000" a row axis of four tiles that is not a multiple
# of 32, "spill" a K past what a block's shared memory holds even for 32
# rows: its row side and item buffers go to the global scratch.
K1_CASES = {
    "edges": (1, 24, 40, 7, 3, 3, 4, (-1, 0, 6, 7)),
    "wide": (2, 300, 128, 40, 2, 4, 4, (0, 39, 40, -1)),
    "none": (3, 0, 128, 16, 2, 4, 4, (-1, 0, 15, 16)),
    "b70000": (4, 70000, 128, 16, 2, 4, 4, (-1, 0, 15, 16)),
    "rows_1000": (5, 50, 1000, 16, 3, 4, 4, (-1, 0, 15, 16)),
    "spill": (6, 40, 300, 2100, 1, 4, 4, (-1, 0, 2099, 2100)),
}


def k1_case(name: str, dev):
    """(t, masks, taints_ok, req) of a `K1_CASES` entry, made from its seed
    with numpy; `t` holds the row tensors, dom_keys and forced_keys."""
    import types

    import numpy as np
    import torch

    from karpenter_tpu_torch.models.scheduler_model import forced_key_mask

    seed, B, Nrows, K, Words, C, R, dom_keys = K1_CASES[name]
    rng = np.random.default_rng(seed)

    def words():
        return rng.integers(0, 1 << 32, size=(B, K, Words), dtype=np.uint64).astype(np.uint32)

    masks = words() | words() | words()  # 7/8 of the bits set
    masks[::2] = np.uint32(0xFFFFFFFF)  # every second item allows every value
    masks[:, :, 0] |= np.uint32(1)  # the absent id 0 is allowed
    labels = np.where(rng.random((Nrows, K)) < 0.8, 0, rng.integers(1, Words * 32 + 40, (Nrows, K))).astype(np.int32)
    neg = np.arange(0, Nrows, 3)
    labels[neg, rng.integers(0, K, neg.size)] = rng.choice(np.array([-1, -2], np.int32), neg.size)
    labels[::5, 0] = -1
    alloc = (rng.integers(1, 64, (Nrows, R))
             * rng.choice(np.array([1000.0, 250.0, 0.25, 3.0, 7.0], np.float32), (Nrows, R))).astype(np.float32)
    alloc[rng.random((Nrows, R)) < 0.1] = np.float32(1e30)
    alloc[-2:] = np.float32(-3.4e38)
    req = rng.choice(np.array([0.0, 0.25, 100.0, 250.0, 1000.0, 3.0], np.float32), size=(B, R))

    def f(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    t = types.SimpleNamespace(row_labels=f(labels, torch.int32),
                              row_taint_class=f(rng.integers(-C - 2, C + 2, Nrows), torch.int32),
                              row_alloc=f(alloc, torch.float32), row_pool_rank=f(rng.integers(-1, 4, Nrows), torch.int32),
                              dom_keys=dom_keys, forced_keys=forced_key_mask(dom_keys, K, dev))
    return t, f(masks.view(np.int32), torch.int32), f(rng.random((B, C)) < 0.8, torch.bool), f(req, torch.float32)


def check_k1_case(name: str, dev, errs: dict) -> None:
    """K1 against its plain version on one of `K1_CASES`: compat equal, key
    equal bit for bit; only "spill" asks for the global scratch."""
    import torch

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, compat_and_key_plain

    _seed, B, Nrows, K, Words, C, R, _dk = K1_CASES[name]
    t, *args = k1_case(name, dev)
    compat, key = compat_and_key(t, *args)
    compat_p, key_p = compat_and_key_plain(t, *args)
    torch.cuda.synchronize()
    expect(torch.equal(compat, compat_p) and same_bits(key, key_p), f"K1 differs from plain on the case {name}")
    scratch = build.lib().kt_feasibility_scratch(B, Nrows, K, Words, C, R)
    expect((scratch > 0) == (name == "spill"), f"K1 case {name}: {scratch} words of global scratch")
    if B:
        errs["feasibility"] = max(errs["feasibility"], max_abs((compat, compat_p), (key, key_p)))
    print(f"K1 == plain (bit for bit): case {name} B={B} Nrows={Nrows} K={K} Words={Words} C={C} R={R}, "
          f"{int(compat.sum())} compatible pairs, {scratch} words of global scratch")


def k1_sites(dev, churn: dict) -> dict:
    """K1's inputs (t, masks, taints_ok, req) at its timed call sites: the
    items of both headlines, of the churn chain's step 1 (`churn`, a
    `drive_chain` run), of the 3800-node fleet and of `caps_wide`, and the
    headline's 5000 pods."""
    from karpenter_tpu_torch.models.scheduler_model import make_tensors, reset_bucket_highwater
    from karpenter_tpu_torch.models.scheduler_model_grouped import build_items, make_item_tensors
    from karpenter_tpu_torch.solver.encoded import load_npz

    def of(t, items):
        return t, items.item_mask, items.item_taint_ok, items.item_req

    sites = {name: of(*prepare(name, dev)[2:4]) for name in (HEADLINE, HEADLINE_AFF)}
    sites[f"{CHURN} step 1"] = of(*churn["steps"][1]["seen"]["dp"][1:3])
    _p, _r, t, pods = perpod_load(HEADLINE, dev)
    sites[f"{HEADLINE} pods"] = (t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    sites[FLEET_BIG] = of(*prepare(FLEET_BIG, dev)[2:4])
    problem, ref = load_npz(CAPS / "caps_wide.npz")
    reset_bucket_highwater()
    items = make_item_tensors(build_items(problem)[0], dev)
    sites["caps_wide"] = of(make_tensors(problem, dev, n_slots=int(ref["ref_n_slots"])), items)
    return sites


def time_k1_sites(dev, churn: dict) -> dict:
    """At each of `k1_sites`: K1 eagerly (CUDA events around back-to-back
    wrapper calls) and graph-replayed (device time), its bound, and an empty
    kernel's launch timed the same two ways right after it."""
    import types

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key

    out = {}
    for name, (t, masks, taints_ok, req) in k1_sites(dev, churn).items():
        compat, key = compat_and_key(t, masks, taints_ok, req)
        n_bytes, ops = k1_cost(t, types.SimpleNamespace(item_req=req, item_mask=masks, item_taint_ok=taints_ok),
                               compat, key)
        bound_ms, bound_by = bound_of(n_bytes, ops)
        B, K, Words = masks.shape
        out[name] = dict(B=B, Nrows=int(t.row_alloc.shape[0]), K=K, Words=Words, R=int(req.shape[1]),
                         ms=cuda_ms(lambda: compat_and_key(t, masks, taints_ok, req), 20),
                         graph_ms=graph_ms(lambda: compat_and_key(t, masks, taints_ok, req), 20),
                         bound_ms=bound_ms, bound_by=bound_by,
                         empty_ms=cuda_ms(lambda: build.empty_launch(dev), 20),
                         empty_graph_ms=graph_ms(lambda: build.empty_launch(dev), 20))
    return out


def k2_cost(t, items, compat, key, init, takes, left) -> tuple[int, int]:
    """K2: the carry, the item and row inputs read once; takes, leftovers and
    the final carry written once. Operations counted from this run's place()
    calls: each touches every slot with ~(3R + 3DR + 12) f32/int ops."""
    R = items.item_req.shape[1]
    D = t.counts_dom_init.shape[1]
    carry = list(init[:7]) + list(init[7])
    t_in = nbytes(t.row_alloc, t.row_pool_rank, t.rank_domset, t.rank_dom_cap, t.dom_key_of, t.group_kind,
                  t.group_skew, t.group_dom_key, t.group_min_domains, t.group_registered, t.row_port_any,
                  t.row_port_wild, t.row_port_spec)
    i_in = nbytes(items.item_req, items.item_dom_allowed, items.item_restrict, items.item_member, items.item_owner,
                  items.item_count, items.item_port_any, items.item_port_wild, items.item_port_spec,
                  items.item_host_blocked, compat, key)
    return (t_in + i_in + 2 * nbytes(*carry) + nbytes(takes, left),
            place_calls(t, items) * t.n_slots * (3 * R + 3 * D * R + 12))


def k3_cost(takes, left, state, flat) -> tuple[int, int]:
    """K3: the take matrix and the tail read once, the flat vector written
    once; one test per take entry."""
    return nbytes(takes, left, state[0], state[2], state[6]) + nbytes(flat), int(takes.numel())


def time_pack(t, items, nnz_cap: int, init_state=None) -> tuple[list, dict]:
    """CUDA-event times of K1, K2 (from `init_state`, else the initial
    carry) and K3, their plain versions and the library yardstick, with the
    bytes and operations of each."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import feasibility, feasibility_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan, pack_scan_plain
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs, flat_outputs_plain
    from karpenter_tpu_torch.models.scheduler_model_grouped import initial_state

    N = t.n_slots
    compat, key = feasibility(t, items)
    takes, left, state = pack_scan(t, items, compat, key, n_slots=N, init_state=init_state)
    flat = flat_outputs(takes, left, state[0], state[2], state[6], nnz_cap)
    init = init_state if init_state is not None else initial_state(t, N)
    torch.cuda.synchronize()
    cost = {"feasibility": k1_cost(t, items, compat, key), "pack_scan": k2_cost(t, items, compat, key, init, takes, left),
            "sparsify": k3_cost(takes, left, state, flat)}
    return [
        dict(name="feasibility", ms=cuda_ms(lambda: feasibility(t, items), 20),
             plain_ms=cuda_ms(lambda: feasibility_plain(t, items), 5), library_ms=None),
        dict(name="pack_scan", ms=cuda_ms(lambda: pack_scan(t, items, compat, key, n_slots=N, init_state=init_state), 3),
             plain_ms=cuda_ms(lambda: pack_scan_plain(t, items, n_slots=N, init_state=init_state,
                                                      precomputed=(compat, key)), 1, rounds=2),
             library_ms=None),
        dict(name="sparsify", ms=cuda_ms(lambda: flat_outputs(takes, left, state[0], state[2], state[6], nnz_cap), 20),
             plain_ms=cuda_ms(lambda: flat_outputs_plain(takes, left, state[0], state[2], state[6], nnz_cap), 5),
             library_ms=cuda_ms(lambda: torch.nonzero(takes), 20),
             graph_ms=graph_ms(lambda: flat_outputs(takes, left, state[0], state[2], state[6], nnz_cap), 20)),
    ], cost


def time_headline(dev, launches: dict, errs: dict) -> list:
    """The `kernels` rows of K1-K3 at the headline shape; K2's also holds its
    time per `place()` call and its kernel time at the affinity headline and
    at the two existing fleets (1200 and 3800 open slots, past the
    shared-memory tile)."""
    from karpenter_tpu_torch.kernels.feasibility import feasibility
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan

    problem, ref, t, items, nnz_cap = prepare(HEADLINE, dev)
    rows, cost = time_pack(t, items, nnz_cap)
    out = [kernel_row(r | dict(bytes=cost[r["name"]][0], ops=cost[r["name"]][1]), launches, errs) for r in rows]
    out[2]["graph_ms"] = rows[2]["graph_ms"]  # K3's device time, without the host's time to launch it
    k2 = out[1]
    k2["place_calls"] = place_calls(t, items)
    k2["us_per_place"] = k2["ms"] * 1e3 / k2["place_calls"]
    for name, key in ((HEADLINE_AFF, "aff"), (FLEET, "fleet"), (FLEET_BIG, "fleet_big")):
        _p, _r, tx, ix, _n = prepare(name, dev)
        cx, kx = feasibility(tx, ix)
        k2[f"{key}_ms"] = cuda_ms(lambda: pack_scan(tx, ix, cx, kx, n_slots=tx.n_slots), 3)
        k2[f"{key}_place_calls"] = place_calls(tx, ix)
        k2[f"{key}_us_per_place"] = k2[f"{key}_ms"] * 1e3 / k2[f"{key}_place_calls"]
    return out


def bound_of(n_bytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over the
    peak memory rate and operations over the peak f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_row(r: dict, launches: dict, errs: dict) -> dict:
    """One entry of the `kernels` line."""
    bound_ms, bound_by = bound_of(r["bytes"], r["ops"])
    return dict(
        name=r["name"], route="cuda", source=f"karpenter_tpu_torch/kernels/csrc/{SOURCES[r['name']]}",
        replaces=REPLACES[r["name"]], launches=launches[r["name"]], max_abs_err=errs[r["name"]],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bound_ms, bound_by=bound_by, library_ms=r["library_ms"],
    )


def host_breakdown(problem, dev, runs: int = 5) -> dict:
    """Median wall ms of each stage of solve_encoded, run stage by stage
    with a synchronise after each (host clock)."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import feasibility
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs
    from karpenter_tpu_torch.models.scheduler_model import make_tensors
    from karpenter_tpu_torch.models.scheduler_model_grouped import (
        _parse_flat,
        assignment_from_triples,
        build_items,
        make_item_tensors,
        nnz_cap_for,
    )
    from karpenter_tpu_torch.solver.check import fast_validate
    from karpenter_tpu_torch.solver.gpu import SLOT_CAP

    stages: dict = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(runs + 1):
        arrays, pods = stage("build_items", lambda: build_items(problem))
        items = stage("item_upload", lambda: make_item_tensors(arrays, dev))
        t = stage("make_tensors", lambda: make_tensors(problem, dev, n_slots=problem.n_existing + min(problem.n_pods, SLOT_CAP)))
        nnz = nnz_cap_for(problem.n_pods, items.item_req.shape[0], t.n_slots)
        compat, key = stage("K1 feasibility", lambda: feasibility(t, items))
        takes, left, st = stage("K2 pack_scan", lambda: pack_scan(t, items, compat, key, n_slots=t.n_slots))
        flat = stage("K3 sparsify", lambda: flat_outputs(takes, left, st[0], st[2], st[6], nnz))
        out = stage("download+parse", lambda: _parse_flat(flat.cpu().numpy(), nnz, t.n_slots, t.counts_dom_init.shape[1],
                                                          items.item_req.shape[0]))
        a = stage("assignment", lambda: assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], pods,
                                                                problem.n_pods))
        stage("fast_validate", lambda: fast_validate(problem, a, out["slot_basis"], out["slot_zoneset"]))
    return {k: statistics.median(v[1:]) for k, v in stages.items()}


def place_calls(t, items) -> int:
    """place() calls the scan makes for these items (per branch: simple 1,
    zone 2D, anti D+1, dom-affinity D, host-affinity 2)."""
    import torch

    D = t.counts_dom_init.shape[1]
    kind = t.group_kind
    mem = items.item_member
    zm = mem & ((kind == 0) | (kind == 3) | (kind == 4))
    hostaff = (mem & (kind == 5)).any(dim=1)
    domaff = (zm & (kind == 4)).any(dim=1)
    anti = (zm & (kind == 3)).any(dim=1)
    zone = zm.any(dim=1)
    calls = torch.where(hostaff, 2, torch.where(domaff, D, torch.where(anti, D + 1, torch.where(zone, 2 * D, 1))))
    return int(calls.sum())


def check_dense_pack(dev) -> dict:
    """`greedy_pack_grouped` (K1 -> K2, dense takes) on the headline problem
    against its plain version and the JAX takes (the stored flat output's
    triples, densified), with the counts set to 0 just before and read just
    after."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan_plain
    from karpenter_tpu_torch.models.scheduler_model_grouped import _parse_flat, greedy_pack_grouped

    problem, ref, t, items, nnz_cap = prepare(HEADLINE, dev)
    W, N = items.item_req.shape[0], t.n_slots
    build.reset_launches()
    takes, left, basis, zoneset, rank, open_count = greedy_pack_grouped(t, items)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    expect(counts["feasibility"] == 1 and counts["pack_scan"] == 1 and counts["sparsify"] == 0,
           f"dense pack launches {counts}")
    takes_p, left_p, state_p = pack_scan_plain(t, items, n_slots=N)
    expect(torch.equal(takes, takes_p) and torch.equal(left, left_p), "dense pack differs from plain")
    expect(torch.equal(basis, state_p[0]) and torch.equal(zoneset, state_p[2]) and torch.equal(rank, state_p[3])
           and torch.equal(open_count, state_p[6]), "dense pack tail differs from plain")
    out = _parse_flat(ref["ref_flat"], nnz_cap, N, t.counts_dom_init.shape[1], W)
    dense = np.zeros((W, N), np.int32)
    ok = out["nz_item"] >= 0
    dense[out["nz_item"][ok], out["nz_slot"][ok]] = out["nz_count"][ok]
    expect(np.array_equal(takes.cpu().numpy(), dense), "dense takes differ from the JAX reference")
    expect(np.array_equal(left.cpu().numpy(), out["leftovers"]), "dense leftovers differ from the JAX reference")
    # the dense pack's bound: K1 -> K2, compat and key stay between them
    from karpenter_tpu_torch.kernels.feasibility import feasibility
    from karpenter_tpu_torch.models.scheduler_model_grouped import initial_state

    compat, key = feasibility(t, items)
    b1, o1 = k1_cost(t, items, compat, key)
    b2, o2 = k2_cost(t, items, compat, key, initial_state(t, N), takes, left)
    bound_ms, bound_by = bound_of(b1 + b2 - 2 * nbytes(compat, key), o1 + o2)
    return dict(launches=counts, replaces="karpenter_tpu/models/scheduler_model_grouped.py:997",
                max_abs_err=max_abs((takes, takes_p), (left, left_p)),
                ms=cuda_ms(lambda: greedy_pack_grouped(t, items), 3),
                plain_ms=cuda_ms(lambda: pack_scan_plain(t, items, n_slots=N), 1, rounds=2),
                bound_ms=bound_ms, bound_by=bound_by)


def chain_env(ref):
    """The environment a chain was made under (its `env` entries)."""
    return switched(dict(str(entry).split("=", 1) for entry in ref["env"]))


def expect_carry(got, ref, prefix: str, what: str) -> None:
    import torch

    for leaf, a in zip(STATE_LEAVES, list(got[:7]) + list(got[7])):
        want = torch.as_tensor(ref[f"{prefix}_{leaf}"])
        expect(torch.equal(a.cpu(), want.reshape(a.shape)), f"{what}: carry {leaf} differs from the JAX reference")


def drive_chain(name: str, dev) -> dict:
    """The delta path's main run: the chain through GPUSolver.solve_encoded,
    every count set to 0 before each step and read after it. The inputs of
    each recredit and delta pack the path makes are kept for check_chain."""
    import numpy as np

    import karpenter_tpu_torch.kernels.recredit as k4
    import karpenter_tpu_torch.solver.gpu as gpu
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.encoded import load_chain

    problems, ref = load_chain(FIXTURES / "chains" / f"{name}.npz")
    seen: dict = {}
    real_k4, real_delta = k4.recredit, gpu.greedy_pack_delta_compressed

    def recredit(state, t, slot_idx, req, zmem, hmem):
        seen["rc"] = (state, t, slot_idx, req, zmem, hmem)
        return real_k4(state, t, slot_idx, req, zmem, hmem)

    def delta_pack(state, t, items, n_added):
        seen["dp"] = (state, t, items, n_added)
        return real_delta(state, t, items, n_added)

    steps, totals = [], {k: 0 for k in build.LAUNCHES}
    with chain_env(ref):
        reset_bucket_highwater()
        solver = gpu.GPUSolver(dev)
        k4.recredit, gpu.greedy_pack_delta_compressed = recredit, delta_pack
        try:
            for i, problem in enumerate(problems):
                seen.clear()
                build.reset_launches()
                res = solver.solve_encoded(problem)
                counts = dict(build.LAUNCHES)
                steps.append(dict(mode=solver.last_solve_mode, reject=solver.last_delta_reject or "", counts=counts,
                                  res=res, seen=dict(seen)))
                totals = {k: totals[k] + v for k, v in counts.items()}
        finally:
            k4.recredit, gpu.greedy_pack_delta_compressed = real_k4, real_delta
    for i, st in enumerate(steps):
        pre, what = f"s{i}.", f"{name} step {i}"
        res = st["res"]
        expect(st["mode"] == str(ref[pre + "ref_mode"]), f"{what}: mode {st['mode']} != {ref[pre + 'ref_mode']}")
        expect(st["reject"] == str(ref[pre + "ref_reject"]), f"{what}: reject {st['reject']!r} != reference")
        expect(res.errors == [], f"{what}: validation errors {res.errors}")
        expect(np.array_equal(res.assignment, ref[pre + "ref_assignment"]), f"{what}: assignment differs")
        expect(np.array_equal(res.slot_basis, ref[pre + "ref_slot_basis"]), f"{what}: slot_basis differs")
        expect(np.array_equal(res.slot_zoneset, ref[pre + "ref_slot_zoneset"]), f"{what}: slot_zoneset differs")
        expect(res.open_count == int(ref[pre + "ref_open_count"]), f"{what}: open count differs")
        expect_carry(res.state, ref, pre + "ref_state", what)
        c = st["counts"]
        # the kernels the reference's step ran, and only those
        rc, dp, full = pre + "rc_slot_idx" in ref, pre + "dp_flat" in ref, st["mode"] == "full"
        expect((c["recredit"] > 0) == rc, f"{what}: recredit launches {c['recredit']} (reference recredited: {rc})")
        packs = int(dp) + int(full)
        for k in ("feasibility", "pack_scan", "sparsify"):
            expect((c[k] > 0) == (packs > 0) and c[k] <= 2 * packs, f"{what}: {k} launches {c[k]}")
    return dict(problems=problems, ref=ref, steps=steps, totals=totals)


def check_chain(run: dict, dev, errs: dict) -> None:
    """Each recredit and delta pack the path made, repeated on its inputs:
    the kernel against its plain version and the stored JAX carry."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import feasibility, feasibility_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan, pack_scan_plain
    from karpenter_tpu_torch.kernels.recredit import recredit, recredit_plain
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs, flat_outputs_plain
    from karpenter_tpu_torch.models.scheduler_model_grouped import delta_nnz_cap

    ref = run["ref"]
    for i, st in enumerate(run["steps"]):
        pre, what = f"s{i}.", f"step {i}"
        if "rc" in st["seen"]:
            state, t, *args = st["seen"]["rc"]
            expect_carry(state, ref, pre + "rc_in", what + " recredit input")
            got = recredit(state, t, *args)
            plain = recredit_plain(state, t, *args)
            torch.cuda.synchronize()
            pairs = list(zip(list(got[:7]) + list(got[7]), list(plain[:7]) + list(plain[7])))
            for leaf, (a, b) in zip(STATE_LEAVES, pairs):
                expect(torch.equal(a, b), f"{what}: K4 {leaf} differs from plain")
            expect_carry(got, ref, pre + "rc_out", what + " K4")
            expect_carry(plain, ref, pre + "rc_out", what + " recredit_plain")
            errs["recredit"] = max(errs["recredit"], max_abs(*pairs))
        if "dp" in st["seen"]:
            state, t, items, n_added = st["seen"]["dp"]
            expect_carry(state, ref, pre + "dp_in", what + " delta pack input")
            nnz = delta_nnz_cap(n_added)
            expect(nnz == int(ref[pre + "dp_nnz_cap"]), f"{what}: delta nnz cap {nnz} != reference")
            compat, key = feasibility(t, items)
            compat_p, key_p = feasibility_plain(t, items)
            takes, left, out = pack_scan(t, items, compat, key, n_slots=t.n_slots, init_state=state)
            takes_p, left_p, out_p = pack_scan_plain(t, items, n_slots=t.n_slots, init_state=state,
                                                     precomputed=(compat_p, key_p))
            flat = flat_outputs(takes, left, out[0], out[2], out[6], nnz)
            flat_p = flat_outputs_plain(takes_p, left_p, out_p[0], out_p[2], out_p[6], nnz)
            torch.cuda.synchronize()
            expect(torch.equal(compat, compat_p) and same_bits(key, key_p), f"{what}: delta K1 differs from plain")
            expect(torch.equal(takes, takes_p) and torch.equal(left, left_p), f"{what}: delta K2 differs from plain")
            leaves = list(zip(list(out[:7]) + list(out[7]), list(out_p[:7]) + list(out_p[7])))
            for leaf, (a, b) in zip(STATE_LEAVES, leaves):
                expect(torch.equal(a, b), f"{what}: delta K2 carry {leaf} differs from plain")
            expect(torch.equal(flat, flat_p), f"{what}: delta K3 differs from plain")
            expect(torch.equal(flat.cpu(), torch.as_tensor(ref[pre + "dp_flat"])),
                   f"{what}: delta flat output differs from the JAX reference")
            expect_carry(out, ref, pre + "dp_out", what + " delta pack")
            errs["feasibility"] = max(errs["feasibility"], max_abs((compat, compat_p), (key, key_p)))
            errs["pack_scan"] = max(errs["pack_scan"], max_abs((takes, takes_p), (left, left_p), *leaves))
            errs["sparsify"] = max(errs["sparsify"], max_abs((flat, flat_p)))


def recredit_cases(dev, seed: int = 0):
    """Synthetic recredits beside the chains' (N = 4096, R = 4, G = 16,
    D = 5, inputs from a seeded numpy generator): 300 removals of which 240
    on one slot, interleaved with padding (the fold order decides the
    rounding); padding entries over a -0.0 in slot 0's capacity (it must
    come back +0.0); 1500 removals, six of K4's 256-removal tiles; 12000
    removals, more than a shared-memory copy of them would hold. Yields
    (name, state, t, slot_idx, req, zmem, hmem)."""
    import types

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    N, R, G, D = 4096, 4, 16, 5
    for name, K in (("one_slot_many", 300), ("padding_neg_zero", 64), ("wide", 1500), ("k_12000", 12000)):
        rem = (rng.integers(0, 1 << 20, (N, R)) * rng.choice([1e-3, 0.1, 7.0], (N, R))).astype(np.float32)
        slot = rng.integers(0, N, K).astype(np.int32)
        if name == "one_slot_many":
            slot[rng.permutation(K)[:240]] = 7
        if name == "padding_neg_zero":
            rem[0] = -0.0
            slot[slot == 0] = 1
        slot[rng.random(K) < 0.15] = -1
        slot[0] = -1
        req = (rng.random((K, R)) * rng.choice([1e-3, 1.0, 1e3], (K, R))).astype(np.float32)
        ports = tuple(torch.as_tensor(rng.random((N, p)) < 0.1, device=dev) for p in (3, 3, 2))
        state = (torch.as_tensor(rng.integers(-1, 128, N).astype(np.int32), device=dev), torch.as_tensor(rem, device=dev),
                 torch.as_tensor(rng.random((N, D)) < 0.5, device=dev),
                 torch.as_tensor(rng.integers(-1, 4, N).astype(np.int32), device=dev),
                 torch.as_tensor(rng.integers(0, 1000, (G, D)).astype(np.int32), device=dev),
                 torch.as_tensor(rng.integers(0, 50, (G, N)).astype(np.int32), device=dev),
                 torch.tensor(N // 2, dtype=torch.int32, device=dev), ports)
        t = types.SimpleNamespace(group_dom_key=torch.as_tensor(rng.integers(-1, 3, G).astype(np.int32), device=dev),
                                  dom_key_of=torch.as_tensor(rng.integers(0, 3, D).astype(np.int32), device=dev))
        zmem = torch.as_tensor(rng.random((K, G)) < 0.2, device=dev)
        hmem = torch.as_tensor(rng.random((K, G)) < 0.2, device=dev)
        yield name, state, t, torch.as_tensor(slot, device=dev), torch.as_tensor(req, device=dev), zmem, hmem


def same_carry(a, b) -> bool:
    """Every leaf equal, f32 leaves bit for bit (so -0.0 != +0.0)."""
    import torch

    for x, y in zip(list(a[:7]) + list(a[7]), list(b[:7]) + list(b[7])):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def check_recredit_cases(dev, errs: dict) -> None:
    """K4 against recredit_plain on `recredit_cases`."""
    import torch

    from karpenter_tpu_torch.kernels.recredit import recredit, recredit_plain

    for name, *args in recredit_cases(dev):
        got, plain = recredit(*args), recredit_plain(*args)
        torch.cuda.synchronize()
        expect(same_carry(got, plain), f"K4 differs from plain on the synthetic case {name}")
        if name == "padding_neg_zero":
            expect(bool((got[1][0].view(torch.int32) == 0).all()), "K4 left a -0.0 in slot 0")
        errs["recredit"] = max(errs["recredit"], max_abs(*zip(list(got[:7]) + list(got[7]),
                                                               list(plain[:7]) + list(plain[7]))))
        print(f"K4 == plain (bit for bit): synthetic {name}, K={args[2].shape[0]}")


def time_recredit(run: dict, launches: dict, errs: dict) -> dict:
    """K4, its plain version and `index_add_` (the one PyTorch call for its
    capacity scatter; atomics, not bit-stable, a yardstick only) with CUDA
    events on the headline churn step's recredit."""
    import torch

    from karpenter_tpu_torch.kernels.recredit import recredit, recredit_plain

    state, t, slot_idx, req, zmem, hmem = run["steps"][1]["seen"]["rc"]
    K, R = req.shape
    G, D = state[4].shape
    valid = slot_idx >= 0
    j = torch.clamp(slot_idx, 0, state[1].shape[0] - 1).long()
    upd = torch.where(valid.unsqueeze(1), req, 0.0)
    scratch = state[1].clone()
    n_valid = int(valid.sum())
    # carry leaves read and written once; the removals and the slot rows of
    # their domain sets read once
    k4_bytes = 2 * nbytes(state[1], state[4], state[5]) + nbytes(slot_idx, req, zmem, hmem, t.group_dom_key,
                                                                 t.dom_key_of) + n_valid * D
    k4_ops = n_valid * (R + 2 * G + G * D)
    row = dict(
        name="recredit", ms=cuda_ms(lambda: recredit(state, t, slot_idx, req, zmem, hmem), 50),
        plain_ms=cuda_ms(lambda: recredit_plain(state, t, slot_idx, req, zmem, hmem), 3),
        library_ms=cuda_ms(lambda: scratch.index_add_(0, j, upd), 50), bytes=k4_bytes, ops=k4_ops,
    )
    graph = dict(graph_ms=graph_ms(lambda: recredit(state, t, slot_idx, req, zmem, hmem), 50),
                 library_graph_ms=graph_ms(lambda: scratch.index_add_(0, j, upd), 50))
    print(f"recredit at {CHURN} step 1: K={K} padded removals ({n_valid} real), N={state[1].shape[0]}, R={R}, G={G}; "
          f"eager (host-issued, CUDA events) {row['ms']:.4f} ms vs index_add_ {row['library_ms']:.4f} ms; "
          f"graph-replayed (device only) {graph['graph_ms']:.4f} ms vs index_add_ {graph['library_graph_ms']:.4f} ms")
    return kernel_row(row, launches, errs) | graph


def time_delta(run: dict, dev, runs: int = 5) -> dict:
    """Host-clock ms (device synchronised) of the headline churn step: the
    delta solve from the base's carry beside a full solve of the same
    problem, each with its stage breakdown, and the delta pack's K1-K3 with
    CUDA events."""
    import torch

    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.models.scheduler_model_grouped import delta_nnz_cap
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    base, step = run["problems"][0], run["problems"][1]
    delta_ms, full_ms, delta_stages, full_stages = [], [], [], []
    for _ in range(runs + 1):
        reset_bucket_highwater()
        solver = GPUSolver(dev)
        solver.solve_encoded(base)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve_encoded(step)
        torch.cuda.synchronize()
        delta_ms.append((time.perf_counter() - t0) * 1e3)
        expect(solver.last_solve_mode == "delta" and res.errors == [], "timed delta solve left the delta path")
        reset_bucket_highwater()
        fresh = GPUSolver(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fresh.solve_encoded(step)
        torch.cuda.synchronize()
        full_ms.append((time.perf_counter() - t0) * 1e3)
        expect(fresh.last_solve_mode == "full" and res.errors == [], "timed full solve failed")
        reset_bucket_highwater()
        staged = GPUSolver(dev, stage_times=True)
        staged.solve_encoded(step)
        full_stages.append(dict(staged.last_stages))
        reset_bucket_highwater()
        staged = GPUSolver(dev, stage_times=True)
        staged.solve_encoded(base)
        staged.solve_encoded(step)
        delta_stages.append(dict(staged.last_stages))
    state, t, items, n_added = run["steps"][1]["seen"]["dp"]
    rows, cost = time_pack(t, items, delta_nnz_cap(n_added), init_state=state)
    kernels = {}
    for r in rows:
        bound_ms, bound_by = bound_of(*cost[r["name"]])
        kernels[r["name"]] = dict(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"], bound_ms=bound_ms,
                                  bound_by=bound_by) | ({"graph_ms": r["graph_ms"]} if "graph_ms" in r else {})

    def med(rows):
        return {k: statistics.median(r.get(k, 0.0) for r in rows[1:]) for k in rows[-1]}

    return dict(delta_ms=statistics.median(delta_ms[1:]), full_ms=statistics.median(full_ms[1:]),
                delta_runs=delta_ms, full_runs=full_ms, delta_stages=med(delta_stages),
                full_stages=med(full_stages), delta_kernels_ms=kernels, delta_place_calls=place_calls(t, items),
                W=int(items.item_req.shape[0]),
                n_added=int(n_added), n_pods=step.n_pods)


# -- consolidation (K5 globalpack, K6 score_subsets, K7 anneal) ---------------------

def cons_load(name: str):
    from karpenter_tpu_torch.solver.consolidation import load_npz

    return load_npz(CONS / f"{name}.npz")


def check_globalpack(name, problem, ref, dev, errs) -> None:
    """K5 after 1, 5 and the full 300 steps against its plain version on the
    card and the stored JAX d and objective."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.kernels.globalpack import globalpack, globalpack_plain
    from karpenter_tpu_torch.solver.consolidation import reference_inits, tensors_from_problem

    t, aux = tensors_from_problem(problem, dev)
    d0, y0 = (torch.as_tensor(a, device=dev) for a in reference_inits(problem, ref))
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0)
    scale = float(problem.node_price.sum())
    for n_iters, key, skey in ((1, "ref_d_it1", "ref_score_it1"), (5, "ref_d_it5", "ref_score_it5"),
                               (int(ref["ref_n_iters"]), "ref_d", "ref_lp_score")):
        d, s = globalpack(*args, n_iters)
        d_p, s_p = globalpack_plain(*args, n_iters)
        torch.cuda.synchronize()
        err = max_abs((d, d_p))
        errs["globalpack"] = max(errs["globalpack"], err)
        expect(err <= D_TOL, f"{name}: K5 d after {n_iters} steps differs from plain by {err}")
        ref_err = float(np.abs(d.cpu().numpy() - ref[key]).max())
        errs["globalpack_vs_jax"] = max(errs.get("globalpack_vs_jax", 0.0), ref_err)
        expect(ref_err <= D_TOL, f"{name}: K5 d after {n_iters} steps differs from JAX by {ref_err}")
        for what, a, b in (("plain", s.cpu().numpy(), s_p.cpu().numpy()), ("JAX", s.cpu().numpy(), ref[skey])):
            if n_iters in GP_SCORE_TOL:
                ok = np.allclose(a, b, rtol=GP_SCORE_TOL[n_iters], atol=0)
            else:
                ok = np.allclose(a, b, rtol=0, atol=GP_FINAL_TOL * scale)
            expect(ok, f"{name}: K5 objective after {n_iters} steps differs from {what}: {a} vs {b}")


def check_score_subsets(name, problem, ref, dev, errs) -> None:
    """K6 on the reference's rounded rows: equal to its plain version and to
    the JAX scores and flags, bit for bit."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.kernels.score_subsets import score_subsets, score_subsets_plain
    from karpenter_tpu_torch.solver.consolidation import tensors_from_problem

    t, aux = tensors_from_problem(problem, dev)
    X = torch.as_tensor(ref["ref_X"], device=dev)
    pend = (aux["pend_req"], aux["pend_npods"], aux["pend_active"])
    s, f = score_subsets(t, aux["onehot"], aux["compat_nq"], *pend, X)
    s_p, f_p = score_subsets_plain(t, aux["onehot"], aux["compat_nq"], *pend, X)
    torch.cuda.synchronize()
    errs["score_subsets"] = max(errs["score_subsets"], max_abs((s, s_p), (f, f_p)))
    expect(torch.equal(s, s_p) and torch.equal(f, f_p), f"{name}: K6 differs from plain")
    expect(np.array_equal(s.cpu().numpy(), ref["ref_scores"]), f"{name}: K6 scores differ from JAX")
    expect(np.array_equal(f.cpu().numpy(), ref["ref_feas"]), f"{name}: K6 feasibility differs from JAX")


def check_anneal(name, problem, ref, dev, errs) -> None:
    """K7 on the reference's streams: equal to its plain version and to the
    JAX best_x and best_s, bit for bit."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.kernels.anneal import anneal, anneal_plain
    from karpenter_tpu_torch.solver.consolidation import tensors_from_problem

    t, _aux = tensors_from_problem(problem, dev, dense_compat=True)
    streams = [torch.as_tensor(ref[k], device=dev) for k in ("ref_x0", "ref_flips", "ref_u")]
    check_prepass(name, t, streams[1], errs)
    bx, bs = anneal(t, *streams)
    bx_p, bs_p = anneal_plain(t, *streams)
    torch.cuda.synchronize()
    errs["anneal"] = max(errs["anneal"], max_abs((bx, bx_p), (bs, bs_p)))
    expect(torch.equal(bx, bx_p) and torch.equal(bs, bs_p), f"{name}: K7 differs from plain")
    expect(np.array_equal(bx.cpu().numpy(), ref["ref_best_x"]), f"{name}: K7 best_x differs from JAX")
    expect(np.array_equal(bs.cpu().numpy(), ref["ref_best_s"]), f"{name}: K7 best_s differs from JAX")


def check_prepass(name, t, flips, errs) -> None:
    """K7's pre-pass (the bit-packed compatibility rows, the undominated
    replacement rows, the flag) against its plain version, bit for bit."""
    import torch

    from karpenter_tpu_torch.kernels.anneal import anneal_prepass, anneal_prepass_plain

    got = anneal_prepass(t, flips)
    want = anneal_prepass_plain(t, flips)
    torch.cuda.synchronize()
    expect(int(got[3].item()) == 0, f"{name}: K7 pre-pass raised its flag")
    errs["anneal_pack"] = max(errs.get("anneal_pack", 0.0), max_abs(*zip(got[:3], want)))
    expect(all(torch.equal(a, b) for a, b in zip(got[:3], want)), f"{name}: K7 pre-pass differs from plain")


def check_proposer_kernels(dev, errs) -> None:
    names = sorted(p.stem for p in CONS.glob("*.npz"))
    expect({CONS_LP, CONS_GLOBAL, CONS_PENDING, CONS_ANNEAL} <= set(names), "consolidation fixtures missing")
    for name in names:
        t1 = time.perf_counter()
        problem, ref = cons_load(name)
        if str(ref["kind"]) == "anneal":
            check_anneal(name, problem, ref, dev, errs)
            what = "K7"
        else:
            check_globalpack(name, problem, ref, dev, errs)
            check_score_subsets(name, problem, ref, dev, errs)
            what = "K5 (1, 5, 300 steps), K6"
        print(f"consolidation kernels == plain == JAX reference: {name} N={problem.n} {what} "
              f"({time.perf_counter() - t1:.1f} s)")


def drive_proposers(dev) -> dict:
    """Each proposer end to end on its fixture, every count set to 0 just
    before the call and read just after; returns the counts per run."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.solver.consolidation import (
        propose_problem_anneal,
        propose_problem_global,
        propose_problem_lp,
        reference_inits,
        reference_proposals,
    )
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    runs = {}
    for name in (CONS_LP, CONS_GLOBAL, CONS_PENDING, CONS_NEAR_TIE):
        problem, ref = cons_load(name)
        inits = reference_inits(problem, ref)
        build.reset_launches()
        if str(ref["kind"]) == "lp":
            out = propose_problem_lp(problem, dev, inits=inits)
        else:
            out, info = propose_problem_global(problem, dev, inits=inits)
            expect(info["rounded"] == int(ref["ref_info_rounded"]), f"{name}: rounded rows differ from JAX")
            want = float(ref["ref_info_objective_improvement"])
            expect(abs(info["objective_improvement"] - want) <= 1e-5 * max(1.0, abs(want)),
                   f"{name}: objective improvement {info['objective_improvement']} != {want}")
        counts = dict(build.LAUNCHES)
        expect(counts["globalpack"] == 1 and counts["score_subsets"] == 1 and counts["anneal"] == 0,
               f"{name}: proposer launches {counts}")
        expect(out == reference_proposals(ref), f"{name}: proposals differ from the JAX reference")
        runs[name] = counts
        print(f"main path {name} ({problem.n} nodes): {len(out)} proposals == JAX (sizes {[len(s) for s in out]}), "
              f"launches {counts}")
    problem, ref = cons_load(CONS_PENDING)
    build.reset_launches()
    out, info = GPUSolver(dev).global_repack_plan_encoded(problem, seed=0)
    counts = dict(build.LAUNCHES)
    expect(counts["globalpack"] == 1 and counts["score_subsets"] == 1, f"global_repack_plan_encoded launches {counts}")
    expect(out == reference_proposals(ref) and info["rounded"] == int(ref["ref_info_rounded"]),
           "global_repack_plan_encoded (its own draws of the reference's inits) differs from the JAX proposals")
    runs["global_repack_plan_encoded"] = counts
    print(f"main path GPUSolver.global_repack_plan_encoded {CONS_PENDING} (the reference's inits drawn for seed 0): "
          f"{len(out)} proposals == JAX, info {info}, launches {counts}")
    problem, ref = cons_load(CONS_ANNEAL)
    build.reset_launches()
    out = propose_problem_anneal(problem, dev, streams=(ref["ref_x0"], ref["ref_flips"], ref["ref_u"]))
    counts = dict(build.LAUNCHES)
    expect(counts["anneal"] == 1 and counts["anneal_pack"] == 1 and counts["globalpack"] == 0,
           f"{CONS_ANNEAL}: proposer launches {counts}")
    expect(out == reference_proposals(ref), f"{CONS_ANNEAL}: proposals differ from the JAX reference")
    runs[CONS_ANNEAL] = counts
    print(f"main path {CONS_ANNEAL} ({problem.n} nodes): {len(out)} proposals == JAX, launches {counts}")
    return runs


def k5_cost(t, aux, C, n_iters) -> tuple[int, int]:
    """K5: inputs read once, d and the objective written once; per step and
    init ~2 flops per term of the six node/row contractions (disp, routed,
    g_disp, g_y, g_d, rep, g_rep, g_yr) and ~20 per node, row and route for
    the hinges, Adam and the projection."""
    Np, Qp = aux["onehot"].shape
    T, R = t.row_alloc.shape
    n_in = nbytes(t.node_price, t.node_cost, t.node_slack, t.node_used, t.row_price, t.row_alloc, aux["onehot"],
                  aux["compat_qn"], aux["pend_mass"], aux["pend_weight"]) + 4 * C * (Np + Qp * Np)
    per_step = 2 * (5 * Np * Qp * R + 3 * T * Qp * R) + 20 * (Np * R + T * R + Np + Qp * (Np + T))
    return n_in + 4 * C * (Np + 1), C * n_iters * per_step


def k6_cost(t, aux, M) -> tuple[int, int]:
    """K6: the node and row arrays and the rows read once, scores and flags
    written once; per row ~(4R + 2Q + 6) operations per node and 3R per
    replacement row."""
    Np, Qp = aux["onehot"].shape
    T, R = t.row_alloc.shape
    n_in = nbytes(t.node_price, t.node_cost, t.node_slack, t.node_used, t.node_npods, aux["onehot"],
                  aux["compat_nq"], t.row_alloc, t.row_price) + M * Np
    return n_in + 5 * M, M * (Np * (4 * R + 2 * Qp + 6) + T * 3 * R)


def pack_cost(t, C, S) -> tuple[int, int]:
    """K7's pre-pass: the dense matrix, the rows and the flips read once, the
    two bit matrices, the row marks and the flag written once; one test per
    matrix entry and (R + 1) comparisons per pair of rows."""
    Np = t.node_price.shape[0]
    T, R = t.row_alloc.shape
    words = Np * ((Np + 31) // 32)
    return (nbytes(t.pod_compat, t.row_alloc, t.row_price) + 4 * C * S + 2 * 4 * words + T + 4,
            Np * Np + T * T * (R + 1))


def k7_cost(t, C, S) -> tuple[int, int]:
    """K7: the node arrays, the dense compatibility matrix, the rows and the
    streams read once, best_x and best_s written once; per step ~(4R + 8)
    operations per node (the objective of the flipped set) and 3R per row."""
    Np = t.node_price.shape[0]
    T, R = t.row_alloc.shape
    n_in = nbytes(t.node_price, t.node_cost, t.node_slack, t.node_used, t.node_npods, t.pod_compat, t.row_alloc,
                  t.row_price) + C * Np + 8 * C * S
    return n_in + C * Np + 4 * C, C * (S + 1) * (Np * (4 * R + 8) + T * 3 * R)


def time_consolidation(dev, launches: dict, errs: dict, arms_k7: dict | None = None) -> list:
    """The `kernels` rows of K5-K7 at the 5000-node shapes (CUDA events);
    K7's row also carries its times on the anneal pass's tensors
    (`arms_k7`, from `check_consolidate_arms`)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.kernels.anneal import anneal, anneal_plain, anneal_prepass, anneal_prepass_plain
    from karpenter_tpu_torch.kernels.globalpack import globalpack, globalpack_plain
    from karpenter_tpu_torch.kernels.score_subsets import score_subsets, score_subsets_plain
    from karpenter_tpu_torch.models.consolidation_model import draw_anneal_streams
    from karpenter_tpu_torch.solver.consolidation import lp_ladder, reference_inits, tensors_from_problem

    problem, ref = cons_load(CONS_LP)
    t, aux = tensors_from_problem(problem, dev)
    d0, y0 = (torch.as_tensor(a, device=dev) for a in reference_inits(problem, ref))
    n_iters = int(ref["ref_n_iters"])
    gp_args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0, n_iters)
    rows = []
    b, o = k5_cost(t, aux, d0.shape[0], n_iters)
    rows.append(dict(name="globalpack", ms=cuda_ms(lambda: globalpack(*gp_args), 3, rounds=3),
                     plain_ms=cuda_ms(lambda: globalpack_plain(*gp_args), 1, rounds=2), library_ms=None,
                     bytes=b, ops=o))
    _out, X, _s, _f = lp_ladder(t, aux, ref["ref_d"], problem.n)
    Xp = np.zeros((len(X) + (-len(X) % 32), X.shape[1]), bool)
    Xp[:len(X)] = X
    Xt = torch.as_tensor(Xp, device=dev)
    k6_args = (t, aux["onehot"], aux["compat_nq"], aux["pend_req"], aux["pend_npods"], aux["pend_active"], Xt)
    b, o = k6_cost(t, aux, Xt.shape[0])
    rows.append(dict(name="score_subsets", ms=cuda_ms(lambda: score_subsets(*k6_args), 20),
                     graph_ms=graph_ms(lambda: score_subsets(*k6_args), 20),
                     plain_ms=cuda_ms(lambda: score_subsets_plain(*k6_args), 3), library_ms=None, bytes=b, ops=o))
    print(f"K5 at {CONS_LP}: C={d0.shape[0]} inits x {n_iters} steps, Np={t.node_price.shape[0]}, "
          f"Qp={aux['onehot'].shape[1]}, Tp={t.row_price.shape[0]}, R={t.row_alloc.shape[1]}; "
          f"K6: {Xt.shape[0]} rows (the proposer's {len(X)} padded to 32s)")
    # K7 on the anneal arm's fleet, and at the 5000-node fleet's Np with the dense matrix
    a_problem, a_ref = cons_load(CONS_ANNEAL)
    ta, _ = tensors_from_problem(a_problem, dev, dense_compat=True)
    streams = [torch.as_tensor(a_ref[k], device=dev) for k in ("ref_x0", "ref_flips", "ref_u")]
    b, o = pack_cost(ta, *streams[1].shape)
    rows.append(dict(name="anneal_pack", ms=cuda_ms(lambda: anneal_prepass(ta, streams[1]), 20),
                     plain_ms=cuda_ms(lambda: anneal_prepass_plain(ta, streams[1]), 3), library_ms=None,
                     bytes=b, ops=o))
    b, o = k7_cost(ta, *streams[1].shape)
    rows.append(dict(name="anneal", ms=cuda_ms(lambda: anneal(ta, *streams), 5, rounds=3),
                     plain_ms=cuda_ms(lambda: anneal_plain(ta, *streams), 1, rounds=2), library_ms=None,
                     bytes=b, ops=o))
    t8, _ = tensors_from_problem(problem, dev, dense_compat=True)
    s8 = draw_anneal_streams(t8.node_price.shape[0], 0, dev)
    check_prepass(f"{CONS_LP} fleet, Np = 8192", t8, s8[1], errs)
    bx, bs = anneal(t8, *s8)
    bx_p, bs_p = anneal_plain(t8, *s8)
    torch.cuda.synchronize()
    expect(torch.equal(bx, bx_p) and torch.equal(bs, bs_p), "K7 at Np = 8192 differs from plain")
    errs["anneal"] = max(errs["anneal"], max_abs((bx, bx_p), (bs, bs_p)))
    b8, o8 = k7_cost(t8, *s8[1].shape)
    bound8, by8 = bound_of(b8, o8)
    k7_8192 = dict(ms=cuda_ms(lambda: anneal(t8, *s8), 2, rounds=3), plain_ms=cuda_ms(lambda: anneal_plain(t8, *s8), 1,
                                                                                       rounds=2),
                   bound_ms=bound8, bound_by=by8, pod_compat_mb=nbytes(t8.pod_compat) / 1e6,
                   pack_ms=cuda_ms(lambda: anneal_prepass(t8, s8[1]), 5, rounds=3))
    pb8, pby8 = bound_of(*pack_cost(t8, *s8[1].shape))
    print(f"time anneal at Np={t8.node_price.shape[0]} (the 5000-node fleet, dense pod_compat "
          f"{k7_8192['pod_compat_mb']:.0f} MB; == plain): {k7_8192['ms']:.4f} ms kernel (pre-pass and chains), "
          f"{k7_8192['plain_ms']:.4f} ms plain, bound {bound8:.5f} ms ({by8}); the pre-pass alone "
          f"{k7_8192['pack_ms']:.4f} ms, bound {pb8:.5f} ms ({pby8})")
    print(f"K7 at {CONS_ANNEAL}: C={streams[1].shape[0]} chains x {streams[1].shape[1]} steps, "
          f"Np={ta.node_price.shape[0]}, Tp={ta.row_price.shape[0]}")
    out = [kernel_row(r, launches, errs) for r in rows]
    out[1].update(graph_ms=rows[1]["graph_ms"])
    out[-1].update(np8192_ms=k7_8192["ms"], np8192_plain_ms=k7_8192["plain_ms"], np8192_bound_ms=bound8,
                   np8192_pack_ms=k7_8192["pack_ms"])
    if arms_k7 is not None:
        out[-1].update(np128_pass_ms=arms_k7["ms"], np128_pass_plain_ms=arms_k7["plain_ms"],
                       np128_pass_bound_ms=arms_k7["bound_ms"], np128_pass_pack_ms=arms_k7["pack_ms"])
    return out


def time_proposers(dev, runs: int = 5) -> dict:
    """Host-clock ms (device synchronised) of the LP and global proposers on
    their 5000-node fleets: median of `runs` warm calls, and the median of
    each stage over `runs` staged calls."""
    import torch

    from karpenter_tpu_torch.obs.trace import SolveTrace
    from karpenter_tpu_torch.solver.consolidation import (
        propose_problem_global,
        propose_problem_lp,
        reference_inits,
    )

    out = {}
    for name, fn in ((CONS_LP, propose_problem_lp), (CONS_GLOBAL, propose_problem_global),
                     (CONS_PENDING, propose_problem_global)):
        problem, ref = cons_load(name)
        inits = reference_inits(problem, ref)
        wall, stages = [], []
        for _ in range(runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(problem, dev, inits=inits)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            trace = SolveTrace(enabled=True)
            fn(problem, dev, inits=inits, trace=trace, sync=True)
            stages.append({k: v * 1e3 for k, v in trace.phase_totals.items()})
        med = {k: statistics.median(s[k] for s in stages[1:]) for k in stages[-1]}
        out[name] = dict(ms=statistics.median(wall[1:]), runs=wall, stages=med)
        print(f"{fn.__name__} {name}: median of {runs} warm calls {out[name]['ms']:.3f} ms "
              f"(runs ms: {[round(x, 3) for x in wall]}); stages ms (median, synchronised): "
              + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    return out


# -- problems past the kernels' former axis limits --------------------------------------

CAPS = FIXTURES / "caps"
CAPS_PACKS = ("caps_groups", "caps_wide")


def synthetic_round(n: int = 100, n_classes: int = 70, n_rows: int = 24, R: int = 20, seed: int = 6) -> dict:
    """A consolidation round in the consolidation encoder's layout
    (`ConsolidationProblem.from_reference`): n nodes of `n_classes` classes,
    R resources, 8 label sets, `n_rows` replacement rows, drawn from `seed`.
    The defaults are `fixtures/caps/caps_lp.npz`'s round
    (tests/test_torch_axis_caps.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L = 8
    f32 = np.float32
    used = (rng.integers(0, 4, (n, R)) * rng.random((n, R))).astype(f32)
    slack = (rng.integers(0, 3, (n, R)) * rng.random((n, R))).astype(f32)
    compat_lq = (rng.random((L, n_classes)) < 0.6).astype(f32)
    compat_lq[:, 0] = 1.0
    alloc = (rng.integers(1, 9, (n_rows, R)) * rng.random((n_rows, R)) + 0.5).astype(f32)
    return dict(
        node_price=rng.uniform(0.1, 2.0, n).astype(f32),
        node_cost=rng.uniform(0.0, 1.0, n).astype(f32),
        node_slack=slack,
        node_used=used,
        node_npods=rng.integers(1, 6, n).astype(f32),
        class_of_node=(np.arange(n) % n_classes).astype(np.int64),
        label_of_node=rng.integers(0, L, n).astype(np.int64),
        compat_lq=compat_lq,
        rows_alloc=alloc,
        rows_price=rng.uniform(0.2, 3.0, n_rows).astype(f32),
        n_classes=n_classes,
        pend_mass=np.zeros((n_classes, R), dtype=f32),
        pend_active=np.zeros(n_classes, dtype=f32),
        pend_req=np.zeros(R, dtype=f32),
        pend_npods=0.0,
    )


# K6 past one tile: synthetic rounds of n nodes, R resources and classes
# (Np = 256: one block; 8192: 8 blocks of one 1024-node tile; 32768: 8 of 4)
K6_SIZES = {256: (200, 4, 4), 8192: (5000, 4, 4), 32768: (20000, 20, 70)}


def check_score_subsets_size(Np: int, pending: bool, dev) -> float:
    """K6 against its plain version, bit for bit, on 32 rows of mixed
    density (pad nodes set in some) of the `K6_SIZES` round at Np, without
    or with pending pods; returns the largest difference (0)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.kernels.score_subsets import score_subsets, score_subsets_plain
    from karpenter_tpu_torch.solver import consolidation as tcons

    n, R, n_classes = K6_SIZES[Np]
    v = synthetic_round(n=n, n_classes=n_classes, n_rows=64, R=R, seed=Np + pending)
    if pending:
        rng = np.random.default_rng(Np)
        v["pend_req"] = rng.uniform(0.5, 4.0, R).astype(np.float32)
        v["pend_npods"] = 3.0
        v["pend_active"][:2] = 1.0
        v["pend_mass"][:2] = rng.uniform(0.1, 1.0, (2, R)).astype(np.float32)
    t, aux = tcons.tensors_from_problem(tcons.ConsolidationProblem.from_reference(v), dev)
    expect(aux["onehot"].shape[0] == Np, f"K6 size case: Np {aux['onehot'].shape[0]} != {Np}")
    gen = torch.Generator(device=dev).manual_seed(Np)
    dens = torch.tensor([0.01, 0.1, 0.5, 0.9], device=dev).repeat(8).unsqueeze(1)
    X = torch.rand((32, Np), generator=gen, device=dev) < dens
    X[::3, n:] = False
    X[0] = False
    pend = (aux["pend_req"], aux["pend_npods"], aux["pend_active"])
    got = score_subsets(t, aux["onehot"], aux["compat_nq"], *pend, X)
    want = score_subsets_plain(t, aux["onehot"], aux["compat_nq"], *pend, X)
    torch.cuda.synchronize()
    expect(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
           f"Np={Np}{' with pending pods' if pending else ''}: K6 differs from plain")
    expect(bool(want[1].any()), f"Np={Np}: no feasible row")
    return max_abs(*zip(got, want))


def k5_widened(t, aux, d0, y0, n_iters: int) -> dict:
    """K5's arguments widened to shapes its other builds take: R + 1 (a
    resource that is half the first) and twice the classes (each class split
    in two by node parity). At `lp_5000` (Np = 8192) the first takes the
    build with Q and R read at run time and everything in shared memory,
    the second (Qp = 8) the one whose Adam moments are in the global
    scratch."""
    import dataclasses

    import torch

    def widen(x):
        return torch.cat([x, x[:, :1] * 0.5], 1).contiguous()

    def two(x):
        return torch.cat([x, x], 0).contiguous()

    t5 = dataclasses.replace(t, node_slack=widen(t.node_slack), node_used=widen(t.node_used),
                             row_alloc=widen(t.row_alloc))
    onehot, compat, mass, weight = aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"]
    odd = (torch.arange(onehot.shape[0], device=onehot.device) % 2 == 1).unsqueeze(1)
    onehot2 = torch.cat([onehot * ~odd, onehot * odd], 1).contiguous()
    R, Q = t.node_used.shape[1], onehot.shape[1]
    return {
        f"R={R + 1}": (t5, onehot, compat, widen(mass), weight, d0, y0, n_iters),
        f"Qp={2 * Q}": (t, onehot2, two(compat), two(mass), two(weight), d0, torch.cat([y0, y0], 1).contiguous(),
                        n_iters),
    }


def check_caps(dev, errs: dict) -> dict:
    """Every kernel whose axes were capped, on problems past the caps, held
    to its plain version on the card: K2 (a full pack, then the same items
    again from its carry: the delta path's entry) and K8 on `caps_groups`
    (G = 264) and `caps_wide` (R = 20, D = 121, Q = 36, Kd = 40, 40 host
    ports), both also against the stored JAX outputs; K5 (after 1, 5 and 300
    steps), K6 and K7 on `caps_lp` / `caps_anneal` (R = 20, Qp = 128), K6
    and K7 also against JAX; K5 on `lp_5000` widened to R = 5 and to Qp = 8
    (`k5_widened`: its builds other than the common shape's); then K5 (1 and 300 steps), K6 and K7 at Np = 32768 with
    R = 20 and Qp = 128, where K5's and K7's blocks' state is past their shared-memory
    budget (K5's arena and K7's per-chain state; K7 with the dense 4.3 GB
    compatibility matrix); K7's pre-pass against its plain version on both
    anneal problems. Returns the shapes checked."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.kernels.anneal import anneal, anneal_plain
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, feasibility, feasibility_plain
    from karpenter_tpu_torch.kernels.globalpack import globalpack, globalpack_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan, pack_scan_plain
    from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack, perpod_pack_plain
    from karpenter_tpu_torch.kernels.score_subsets import score_subsets, score_subsets_plain
    from karpenter_tpu_torch.models.scheduler_model import make_pod_tensors, make_tensors, reset_bucket_highwater
    from karpenter_tpu_torch.models.scheduler_model_grouped import _flat_outputs, build_items, make_item_tensors
    from karpenter_tpu_torch.solver import consolidation as tcons
    from karpenter_tpu_torch.solver.encoded import load_npz

    shapes = {}
    for name in CAPS_PACKS:
        t1 = time.perf_counter()
        problem, ref = load_npz(CAPS / f"{name}.npz")
        reset_bucket_highwater()
        arrays, _pods = build_items(problem)
        items = make_item_tensors(arrays, dev)
        t = make_tensors(problem, dev, n_slots=int(ref["ref_n_slots"]))
        compat, key = feasibility(t, items)
        compat_p, key_p = feasibility_plain(t, items)
        expect(torch.equal(compat, compat_p) and same_bits(key, key_p), f"{name}: K1 differs from plain")
        takes, left, state = pack_scan(t, items, compat, key, n_slots=t.n_slots)
        takes_p, left_p, state_p = pack_scan_plain(t, items, n_slots=t.n_slots, precomputed=(compat, key))
        torch.cuda.synchronize()
        leaves, leaves_p = list(state[:7]) + list(state[7]), list(state_p[:7]) + list(state_p[7])
        expect(torch.equal(takes, takes_p) and torch.equal(left, left_p)
               and all(torch.equal(a, b) for a, b in zip(leaves, leaves_p)), f"{name}: K2 differs from plain")
        flat = _flat_outputs(takes, left, state[0], state[2], state[6], int(ref["ref_nnz_cap"]))
        expect(np.array_equal(flat.cpu().numpy(), ref["ref_flat"]), f"{name}: K2's flat output differs from JAX")
        for leaf, x in zip(STATE_LEAVES, leaves):
            expect(np.array_equal(x.cpu().numpy(), ref[f"ref_state_{leaf}"]), f"{name}: K2 carry {leaf} differs from JAX")
        # the same items again, from the carry (the delta pack's entry)
        takes2, left2, state2 = pack_scan(t, items, compat, key, n_slots=t.n_slots, init_state=state)
        takes2_p, left2_p, state2_p = pack_scan_plain(t, items, n_slots=t.n_slots, init_state=state_p,
                                                      precomputed=(compat, key))
        torch.cuda.synchronize()
        expect(torch.equal(takes2, takes2_p) and torch.equal(left2, left2_p)
               and all(torch.equal(a, b) for a, b in zip(list(state2[:7]) + list(state2[7]),
                                                         list(state2_p[:7]) + list(state2_p[7]))),
               f"{name}: K2 from the carry differs from plain")
        # K8 on the reference's default slot axis
        reset_bucket_highwater()
        tp = make_tensors(problem, dev)
        pods = make_pod_tensors(problem, dev, tp)
        pc, pk = compat_and_key(tp, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
        out = perpod_pack(tp, pods, pc, pk)
        out_p = perpod_pack_plain(tp, pods, pc, pk)
        torch.cuda.synchronize()
        expect(all(torch.equal(a, b) for a, b in zip(out, out_p)), f"{name}: K8 differs from plain")
        with np.load(CAPS / f"{name}_perpod.npz", allow_pickle=False) as z:
            for k, a in zip(PERPOD_OUTPUTS, out):
                expect(np.array_equal(a.cpu().numpy(), z[f"ref_{k}"]), f"{name}: K8 {k} differs from JAX")
        G, D = t.counts_dom_init.shape
        shapes[name] = dict(W=int(items.item_req.shape[0]), N=int(t.n_slots), R=int(items.item_req.shape[1]), G=G,
                            D=D, Q=int(t.rank_domset.shape[0]), Kd=int(items.item_restrict.shape[1]),
                            P1=int(items.item_port_any.shape[1]), P2=int(items.item_port_spec.shape[1]))
        print(f"caps {name} {shapes[name]}: K1, K2 (full and from its carry) and K8 == plain, K2 and K8 == JAX "
              f"({time.perf_counter() - t1:.1f} s)")

    t1 = time.perf_counter()
    problem, ref = tcons.load_npz(CAPS / "caps_lp.npz")
    t, aux = tcons.tensors_from_problem(problem, dev)
    d0, y0 = (torch.as_tensor(a, device=dev) for a in tcons.reference_inits(problem, ref))
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0)
    for n_iters in (1, 5, int(ref["ref_n_iters"])):
        d, _s = globalpack(*args, n_iters)
        d_p, _s_p = globalpack_plain(*args, n_iters)
        torch.cuda.synchronize()
        err = max_abs((d, d_p))
        errs["globalpack"] = max(errs["globalpack"], err)
        expect(err <= D_TOL, f"caps_lp: K5 d after {n_iters} steps differs from plain by {err}")
    X = torch.as_tensor(ref["ref_X"], device=dev)
    pend = (aux["pend_req"], aux["pend_npods"], aux["pend_active"])
    s, f = score_subsets(t, aux["onehot"], aux["compat_nq"], *pend, X)
    s_p, f_p = score_subsets_plain(t, aux["onehot"], aux["compat_nq"], *pend, X)
    torch.cuda.synchronize()
    expect(torch.equal(s, s_p) and torch.equal(f, f_p), "caps_lp: K6 differs from plain")
    expect(np.array_equal(s.cpu().numpy(), ref["ref_scores"]), "caps_lp: K6 differs from JAX")
    problem_a, ref_a = tcons.load_npz(CAPS / "caps_anneal.npz")
    ta, _aux = tcons.tensors_from_problem(problem_a, dev, dense_compat=True)
    streams = [torch.as_tensor(ref_a[k], device=dev) for k in ("ref_x0", "ref_flips", "ref_u")]
    check_prepass("caps_anneal", ta, streams[1], errs)
    bx, bs = anneal(ta, *streams)
    bx_p, bs_p = anneal_plain(ta, *streams)
    torch.cuda.synchronize()
    expect(torch.equal(bx, bx_p) and torch.equal(bs, bs_p), "caps_anneal: K7 differs from plain")
    expect(np.array_equal(bs.cpu().numpy(), ref_a["ref_best_s"]), "caps_anneal: K7 differs from JAX")
    shapes["caps_lp"] = dict(Np=int(t.node_price.shape[0]), Qp=int(aux["onehot"].shape[1]), R=int(t.node_used.shape[1]))
    print(f"caps caps_lp / caps_anneal {shapes['caps_lp']}: K5 (1, 5, 300 steps) within {D_TOL} of plain, K6 and K7 "
          f"== plain == JAX ({time.perf_counter() - t1:.1f} s)")

    # K5's builds other than the common shape's, at the 5000-node fleet
    t1 = time.perf_counter()
    problem, ref = cons_load(CONS_LP)
    t, aux = tcons.tensors_from_problem(problem, dev)
    d0, y0 = (torch.as_tensor(a, device=dev) for a in tcons.reference_inits(problem, ref))
    for shape, args in k5_widened(t, aux, d0, y0, int(ref["ref_n_iters"])).items():
        d, _s = globalpack(*args)
        d_p, _s_p = globalpack_plain(*args)
        torch.cuda.synchronize()
        err = max_abs((d, d_p))
        errs["globalpack"] = max(errs["globalpack"], err)
        expect(err <= D_TOL, f"{CONS_LP} at {shape}: K5 d differs from plain by {err}")
        shapes[f"{CONS_LP} {shape}"] = dict(Np=int(d.shape[1]), Qp=int(args[1].shape[1]), R=int(args[0].node_used.shape[1]))
    print(f"caps {CONS_LP} widened to {list(shapes)[-2:]}: K5 (300 steps) within {D_TOL} of plain "
          f"({time.perf_counter() - t1:.1f} s)")

    # past the blocks' shared-memory budget: Np = 32768 (K5's arena, K7's per-chain state)
    t1 = time.perf_counter()
    big = tcons.ConsolidationProblem.from_reference(synthetic_round(n=20000, n_classes=70, n_rows=64, seed=7))
    t, aux = tcons.tensors_from_problem(big, dev, dense_compat=True)
    Np, Qp = aux["onehot"].shape
    gen = torch.Generator(device=dev).manual_seed(0)
    d0 = torch.rand((2, Np), generator=gen, device=dev) * 0.9 + 0.05
    y0 = torch.rand((2, Qp, Np), generator=gen, device=dev) * 0.9 + 0.1
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0)
    for n_iters in (1, 300):
        d, _s = globalpack(*args, n_iters)
        d_p, _s_p = globalpack_plain(*args, n_iters)
        torch.cuda.synchronize()
        err = max_abs((d, d_p))
        errs["globalpack"] = max(errs["globalpack"], err)
        expect(err <= D_TOL, f"Np={Np}: K5 d after {n_iters} steps differs from plain by {err}")
    X = torch.rand((8, Np), generator=gen, device=dev) < 0.3
    X[:, big.n:] = False
    pend = (aux["pend_req"], aux["pend_npods"], aux["pend_active"])
    s, f = score_subsets(t, aux["onehot"], aux["compat_nq"], *pend, X)
    s_p, f_p = score_subsets_plain(t, aux["onehot"], aux["compat_nq"], *pend, X)
    x0 = torch.rand((2, Np), generator=gen, device=dev) < 0.1
    x0[:, big.n:] = False
    flips = torch.randint(0, big.n, (2, 8), generator=gen, device=dev, dtype=torch.int32)
    u = torch.rand((2, 8), generator=gen, device=dev)
    check_prepass(f"Np={Np}", t, flips, errs)
    bx, bs = anneal(t, x0, flips, u)
    bx_p, bs_p = anneal_plain(t, x0, flips, u)
    torch.cuda.synchronize()
    expect(torch.equal(s, s_p) and torch.equal(f, f_p), f"Np={Np}: K6 differs from plain")
    expect(torch.equal(bx, bx_p) and torch.equal(bs, bs_p), f"Np={Np}: K7 differs from plain")
    shapes["large"] = dict(Np=int(Np), Qp=int(Qp), R=int(t.node_used.shape[1]))
    print(f"caps Np={Np} Qp={Qp} R={shapes['large']['R']}: K5 (1, 300 steps) within {D_TOL} of plain, K6 (8 rows) and K7 "
          f"(2 chains x 8 steps) == plain ({time.perf_counter() - t1:.1f} s)")

    # K6's clusters: one block, eight blocks of one tile, eight of four
    t1 = time.perf_counter()
    for size in K6_SIZES:
        for pending in (False, True):
            errs["score_subsets"] = max(errs.get("score_subsets", 0.0), check_score_subsets_size(size, pending, dev))
    shapes["k6_sizes"] = sorted(K6_SIZES)
    print(f"caps K6 at Np = {sorted(K6_SIZES)} (R = 4, 4, 20; without and with pending pods; 32 rows each) == plain "
          f"({time.perf_counter() - t1:.1f} s)")
    return shapes


# -- the per-pod pack (K1 over the pods, K8 perpod_pack) -------------------------------

PERPOD_OUTPUTS = ("assignment", "slot_basis", "slot_domset", "slot_rank", "open_count")
# synthetic per-pod problems around K8's WARP_REACH (64 open slots): case ->
# (seed, existing slots, slot axis N, pods). "below" never passes the reach,
# "cross" and "at_reach" start at or below it and pass it, "above" starts past it.
PERPOD_REGIME_CASES = {"below": (0, 3, 48, 60), "cross": (1, 40, 120, 120), "at_reach": (2, 64, 128, 80),
                       "above": (3, 100, 180, 80)}


def perpod_regime_arrays(seed: int, n_ex: int, N: int, P: int) -> dict:
    """A per-pod problem as numpy arrays (the layout of
    `tests/test_torch_perpod._synthetic`) whose open-slot count starts at
    `n_ex` and grows by a new slot every few pods: small existing nodes,
    offering rows of 2-8 units, pods of 1-3 units that mostly fit any row
    (so pods that take open slots and pods that open new ones alternate),
    hostname anti-affinity owners that need a slot of their own, and the
    groups and domains of `_synthetic` (spread, anti, hostname; two keys)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_off, R, K, C, Q, G = 12, 4, 3, 2, 3, 6
    n_real = n_ex + n_off
    Nrows = n_real + 4  # pad rows
    dom_key_of = np.array([0, 1, 0, 0, 0, 1, 1], np.int32)
    D, Kd = dom_key_of.shape[0], 2
    alloc = rng.choice(np.array([2.0, 4.0, 8.0], np.float32), size=(Nrows, R)).astype(np.float32)
    alloc[:n_ex] = rng.choice(np.array([1.0, 1.5, 2.0], np.float32), size=(n_ex, R))
    alloc[:, -1] = np.float32(1e30)  # a pad resource
    alloc[n_real:] = np.float32(-3.4e38)
    rank = np.concatenate([np.full(n_ex, -1), rng.integers(0, Q, Nrows - n_ex)]).astype(np.int32)
    rank[n_real:] = 0
    kinds = rng.choice(np.array([0, 0, 1, 2, 3, -1], np.int32), size=G).astype(np.int32)
    kinds[0], kinds[1] = 0, 2  # a spread group and a hostname anti group in every case
    ex_dom = np.zeros((n_ex, D), bool)
    for j in range(n_ex):
        ex_dom[j, rng.choice(np.nonzero(dom_key_of == 0)[0])] = True
        ex_dom[j, rng.choice(np.nonzero(dom_key_of == 1)[0])] = True
    counts_host = np.zeros((G, N), np.int32)
    counts_host[:, :n_ex] = rng.integers(0, 2, size=(G, n_ex))
    pod_req = rng.choice(np.array([1.0, 1.0, 2.0, 3.0], np.float32), size=(P, R)).astype(np.float32)
    pod_req[:, -1] = 0.0
    pod_mask = np.full((P, K, 1), 0xFFFFFFFF, np.uint32)
    odd = rng.random(P) < 0.1
    pod_mask[odd] = rng.integers(0, 2**32, size=(int(odd.sum()), K, 1), dtype=np.uint64).astype(np.uint32)
    return dict(
        n_ex=n_ex, n_real=n_real, N=N, alloc=alloc, rank=rank,
        labels=rng.integers(0, 20, size=(Nrows, K)).astype(np.int32),
        taint_class=rng.integers(0, C, Nrows).astype(np.int32), rank_domset=rng.random((Q, D)) < 0.7,
        dom_key_of=dom_key_of, kinds=kinds, skew=rng.integers(1, 3, G).astype(np.int32),
        dom_key=np.where((kinds == 0) | (kinds == 3), rng.integers(0, Kd, G), -1).astype(np.int32),
        min_domains=np.where(rng.random(G) < 0.3, 3, 0).astype(np.int32), registered=rng.random((G, D)) < 0.8,
        counts_dom=rng.integers(0, 3, size=(G, D)).astype(np.int32), counts_host=counts_host, ex_dom=ex_dom,
        pod_req=pod_req, pod_mask=pod_mask, pod_taint_ok=rng.random((P, C)) < 0.95,
        pod_dom_allowed=rng.random((P, D)) < 0.8, pod_restrict=rng.random((P, Kd)) < 0.3,
        member=rng.random((P, G)) < 0.25, owner=rng.random((P, G)) < 0.15,
    )


def perpod_tensors(s: dict, dev):
    """(SchedulerTensors, PodTensors) on `dev` of a per-pod problem given as
    numpy arrays (`perpod_regime_arrays`' layout; no host ports)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.models import scheduler_model as tsm

    def f(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    Nrows, R = s["alloc"].shape
    ports = torch.zeros((Nrows, 4), dtype=torch.bool, device=dev)
    ex_ports = torch.zeros((s["n_ex"], 4), dtype=torch.bool, device=dev)
    b, i32 = torch.bool, torch.int32
    t = tsm.SchedulerTensors(
        n_rows_real=s["n_real"], row_alloc=f(s["alloc"], torch.float32), row_labels=f(s["labels"], i32),
        row_pool_rank=f(s["rank"], i32), row_taint_class=f(s["taint_class"], i32),
        rank_domset=f(s["rank_domset"], b),
        rank_dom_cap=torch.zeros((s["rank_domset"].shape[0], s["dom_key_of"].shape[0], R), device=dev),
        dom_key_of=f(s["dom_key_of"], i32), group_kind=f(s["kinds"], i32), group_skew=f(s["skew"], i32),
        group_dom_key=f(s["dom_key"], i32), group_min_domains=f(s["min_domains"], i32),
        group_registered=f(s["registered"], b), counts_dom_init=f(s["counts_dom"], i32),
        counts_host_init=f(s["counts_host"], i32), existing_domset=f(s["ex_dom"], b), existing_port_any=ex_ports,
        existing_port_wild=ex_ports, existing_port_spec=ex_ports, row_port_any=ports, row_port_wild=ports,
        row_port_spec=ports, dom_keys=(2, -1), forced_keys=tsm.forced_key_mask((2, -1), s["labels"].shape[1], dev),
        n_existing=s["n_ex"], n_slots=s["N"],
    )
    pods = tsm.PodTensors(
        pod_req=f(s["pod_req"], torch.float32), pod_mask=f(s["pod_mask"].view(np.int32), i32),
        pod_taint_ok=f(s["pod_taint_ok"], b), pod_dom_allowed=f(s["pod_dom_allowed"], b),
        pod_restrict=f(s["pod_restrict"], b), member=f(s["member"], b), owner=f(s["owner"], b),
    )
    return t, pods


def open_before(assignment, n_ex: int):
    """The open-slot count each pod saw and whether it opened a new slot,
    from a per-pod assignment (slots open in order)."""
    import numpy as np

    a = np.asarray(assignment)
    seen, opened = np.zeros(a.shape[0], np.int64), np.zeros(a.shape[0], bool)
    open_count = n_ex
    for i, j in enumerate(a.tolist()):
        seen[i] = open_count
        opened[i] = j == open_count
        open_count += int(opened[i])
    return seen, opened


def check_perpod_regimes(dev, errs: dict) -> dict:
    """K1 and K8 against their plain versions (K8: the five outputs and the
    whole carry) on `PERPOD_REGIME_CASES`, which stay below, cross and start past the
    warp's reach; returns each case's first and final open-slot count."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, compat_and_key_plain
    from karpenter_tpu_torch.kernels.perpod_pack import WARP_REACH, perpod_pack, perpod_pack_plain

    out = {}
    for name, (seed, n_ex, N, P) in PERPOD_REGIME_CASES.items():
        t, pods = perpod_tensors(perpod_regime_arrays(seed, n_ex, N, P), dev)
        args = (t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
        compat, key = compat_and_key(*args)
        compat_p, key_p = compat_and_key_plain(*args)
        expect(torch.equal(compat, compat_p) and same_bits(key, key_p), f"regime case {name}: K1 differs from plain")
        got = perpod_pack(t, pods, compat, key)
        want = perpod_pack_plain(t, pods, compat, key)
        torch.cuda.synchronize()
        leaves = PERPOD_OUTPUTS + ("slot_rem", "counts_dom", "counts_host")
        for leaf, a, b in zip(leaves, got, want):
            expect(torch.equal(a, b), f"regime case {name}: K8 {leaf} differs from plain")
        errs["perpod_pack"] = max(errs["perpod_pack"], max_abs(*zip(got, want)))
        out[name] = dict(first_open=n_ex, final_open=int(got[4]), reach=WARP_REACH)
    return out


def perpod_fixture(name: str):
    """A fixture's problem and its stored JAX per-pod outputs and errors."""
    import numpy as np

    from karpenter_tpu_torch.solver.encoded import load_npz

    problem, _ref = load_npz(FIXTURES / f"{name}.npz")
    with np.load(FIXTURES / "perpod" / f"{name}.npz", allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    expect(str(ref["problem"]) == f"{name}.npz" and int(ref["n_pods"]) == problem.n_pods,
           f"{name}: per-pod fixture is not keyed to this problem")
    return problem, ref


def perpod_load(name: str, dev):
    """`perpod_fixture` and the problem's tensors on `dev` (the reference's
    default slot axis)."""
    from karpenter_tpu_torch.models.scheduler_model import make_pod_tensors, make_tensors, reset_bucket_highwater

    problem, ref = perpod_fixture(name)
    reset_bucket_highwater()
    t = make_tensors(problem, dev)
    expect(t.n_slots == int(ref["ref_n_slots"]), f"{name}: per-pod slot axis {t.n_slots} != reference")
    return problem, ref, t, make_pod_tensors(problem, dev, t)


def expect_perpod(problem, ref, out, what: str) -> list:
    """The five outputs against the stored JAX ones, and the validation
    errors against the reference's; returns the errors."""
    import numpy as np

    from karpenter_tpu_torch.solver.check import fast_validate

    for k, a in zip(PERPOD_OUTPUTS, out):
        expect(np.array_equal(a.cpu().numpy(), ref[f"ref_{k}"]), f"{what}: {k} differs from the JAX reference")
    errors = fast_validate(problem, *(x.cpu().numpy() for x in out[:3]))
    expect(errors == list(ref["ref_errors"]), f"{what}: validation errors {errors} != the reference's")
    return errors


def check_perpod(name: str, dev, errs: dict) -> dict:
    """K1 over the pods and K8 against their plain versions on the card,
    and both against the stored JAX per-pod pack."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, compat_and_key_plain
    from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack, perpod_pack_plain

    problem, ref, t, pods = perpod_load(name, dev)
    args = (t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    compat, key = compat_and_key(*args)
    compat_p, key_p = compat_and_key_plain(*args)
    torch.cuda.synchronize()
    expect(torch.equal(compat, compat_p) and same_bits(key, key_p), f"{name}: K1 over the pods differs from plain")
    out = perpod_pack(t, pods, compat, key)
    out_p = perpod_pack_plain(t, pods, compat_p, key_p)
    torch.cuda.synchronize()
    leaves = PERPOD_OUTPUTS + ("slot_rem", "counts_dom", "counts_host")
    for leaf, a, b in zip(leaves, out, out_p):
        expect(torch.equal(a, b), f"{name}: K8 {leaf} differs from plain")
    errors = expect_perpod(problem, ref, out, f"{name} K8")
    errs["feasibility"] = max(errs["feasibility"], max_abs((compat, compat_p), (key, key_p)))
    errs["perpod_pack"] = max(errs["perpod_pack"], max_abs(*zip(out, out_p)))
    return dict(P=problem.n_pods, N=t.n_slots, placed=int((out[0] >= 0).sum()), open=int(out[4]), errors=len(errors))


def drive_perpod(name: str, dev) -> dict:
    """The per-pod entry, `greedy_pack_encoded`, with every count set to 0
    just before and read just after: one K1 and one K8 launch."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import greedy_pack_encoded, reset_bucket_highwater

    problem, ref = perpod_fixture(name)
    reset_bucket_highwater()
    build.reset_launches()
    out = greedy_pack_encoded(problem, dev)
    counts = dict(build.LAUNCHES)
    expect({k: v for k, v in counts.items() if v} == {"feasibility": 1, "perpod_pack": 1},
           f"{name}: greedy_pack launches {counts}")
    errors = expect_perpod(problem, ref, out, f"{name} greedy_pack")
    print(f"main path greedy_pack_encoded {name}: {int((out[0] >= 0).sum())} of {problem.n_pods} placed, "
          f"{int(out[4])} open, {len(errors)} validation errors == reference, launches {counts}")
    return counts


def k8_cost(t, pods, compat, key, out) -> tuple[int, int]:
    """K8: the row, group and pod inputs and K1's outputs read once, the
    initial carry read once, the outputs and final carry written once.
    Operations counted from this run's placement: per pod, (R + 6) per slot
    its first-fit search reaches (up to the slot it took, else every open
    slot), (R + 6) per row for the argmin, and G * D for the skew checks."""
    import numpy as np

    P, R = pods.pod_req.shape
    Nrows = t.row_alloc.shape[0]
    G, D = t.counts_dom_init.shape
    a = out[0].cpu().numpy().astype(np.int64)
    first = np.zeros(P, np.int64)
    _slots, at = np.unique(a[a >= t.n_existing], return_index=True)
    first[np.nonzero(a >= t.n_existing)[0][at]] = 1  # the pod that opened each new slot
    open_before = t.n_existing + np.cumsum(first) - first
    reached = np.where((a >= 0) & (a < open_before), a + 1, open_before)
    n_in = nbytes(t.row_alloc, t.row_pool_rank, t.rank_domset, t.dom_key_of, t.group_kind, t.group_skew,
                  t.group_dom_key, t.group_min_domains, t.group_registered, pods.pod_req, pods.pod_dom_allowed,
                  pods.pod_restrict, pods.member, pods.owner, compat, key)
    carry = nbytes(*out[1:])
    ops = int(reached.sum()) * (R + 6) + P * (Nrows * (R + 6) + G * D)
    return n_in + 2 * carry + nbytes(out[0]), ops


def time_perpod(dev, runs: int = 5) -> dict:
    """At the headline: K8 and K1 over the pods, and their plain versions,
    with CUDA events; the entry `greedy_pack_encoded` on the host clock
    (synchronised), whole and stage by stage."""
    import types

    import torch

    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, compat_and_key_plain
    from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack, perpod_pack_plain
    from karpenter_tpu_torch.models.scheduler_model import (
        greedy_pack_encoded,
        make_pod_tensors,
        make_tensors,
        reset_bucket_highwater,
    )

    problem, _ref, t, pods = perpod_load(HEADLINE, dev)
    args = (t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    compat, key = compat_and_key(*args)
    out = perpod_pack(t, pods, compat, key)
    torch.cuda.synchronize()
    as_items = types.SimpleNamespace(item_req=pods.pod_req, item_mask=pods.pod_mask, item_taint_ok=pods.pod_taint_ok)
    b1, o1 = k1_cost(t, as_items, compat, key)
    bound1, by1 = bound_of(b1, o1)
    k1 = dict(pods_ms=cuda_ms(lambda: compat_and_key(*args), 20),
              pods_plain_ms=cuda_ms(lambda: compat_and_key_plain(*args), 5), pods_bound_ms=bound1, pods_bound_by=by1)
    b8, o8 = k8_cost(t, pods, compat, key, out)
    k8 = dict(name="perpod_pack", ms=cuda_ms(lambda: perpod_pack(t, pods, compat, key), 3),
              plain_ms=cuda_ms(lambda: perpod_pack_plain(t, pods, compat, key), 1, rounds=2), library_ms=None,
              bytes=b8, ops=o8)
    # the existing fleets: every pod past the warp's reach (all warps search)
    for key_ms, name in (("fleet_ms", FLEET), ("fleet_big_ms", FLEET_BIG)):
        _p, _r, tf, pf = perpod_load(name, dev)
        cf, kf = compat_and_key(tf, pf.pod_mask, pf.pod_taint_ok, pf.pod_req)
        k8[key_ms] = cuda_ms(lambda: perpod_pack(tf, pf, cf, kf), 3)
    wall, stages = [], {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(runs + 1):
        reset_bucket_highwater()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_pack_encoded(problem, dev)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        reset_bucket_highwater()
        ts = stage("make_tensors", lambda: make_tensors(problem, dev))
        ps = stage("make_pod_tensors", lambda: make_pod_tensors(problem, dev, ts))
        c, k = stage("K1 over the pods", lambda: compat_and_key(ts, ps.pod_mask, ps.pod_taint_ok, ps.pod_req))
        stage("K8 perpod_pack", lambda: perpod_pack(ts, ps, c, k))
    print(f"K8 at {HEADLINE}: P={pods.pod_req.shape[0]} pods, N={t.n_slots} slots, Nrows={t.row_alloc.shape[0]}, "
          f"R={t.row_alloc.shape[1]}, G={t.counts_dom_init.shape[0]}, D={t.counts_dom_init.shape[1]}; "
          f"at {FLEET} {k8['fleet_ms']:.4f} ms, at {FLEET_BIG} {k8['fleet_big_ms']:.4f} ms (CUDA events)")
    return dict(feasibility_pods=k1, perpod_pack=k8, entry_ms=statistics.median(wall[1:]), entry_runs=wall,
                entry_stages={k: statistics.median(v[1:]) for k, v in stages.items()})


def run(dev, card: str) -> dict:
    """Every check and timing on `dev`; returns the `kernels` line."""
    import torch

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.encoded import load_npz
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    names = sorted(p.stem for p in FIXTURES.glob("*.npz"))
    expect(HEADLINE in names and HEADLINE_AFF in names, "headline fixtures missing")
    errs = {"feasibility": 0.0, "pack_scan": 0.0, "pack_scan_sharded": 0.0, "pack_scan_cluster": 0.0, "sparsify": 0.0,
            "recredit": 0.0, "globalpack": 0.0, "score_subsets": 0.0, "anneal_pack": 0.0, "anneal": 0.0, "perpod_pack": 0.0}
    for name in names:
        t1 = time.perf_counter()
        info = check_kernels(name, dev)
        errs = {k: max(v, info["errs"].get(k, 0.0)) for k, v in errs.items()}
        print(f"kernels == plain == JAX reference: {name} W={info['W']} N={info['N']} ({time.perf_counter() - t1:.1f} s)")
    for name in K1_CASES:
        check_k1_case(name, dev, errs)

    launches, summary = run_main_path(HEADLINE, dev)
    print(f"main path {HEADLINE}: {summary} launches {launches}")
    aff_launches, aff_summary = run_main_path(HEADLINE_AFF, dev)
    print(f"main path {HEADLINE_AFF}: {aff_summary} launches {aff_launches}")
    snapshot = check_snapshot(dev, card, errs)
    solve = check_solve(dev, card, errs)
    t1 = time.perf_counter()
    observability = check_observability(dev, card, solve.pop("inputs"))
    print(f"flight-record phase {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    hybrid = check_hybrid(dev, card, errs)
    t2 = time.perf_counter()
    provision = check_provision(dev, card, errs, runs=3)
    t8 = time.perf_counter()
    wide = check_wide(dev, card, errs)
    print(f"wide phase {time.perf_counter() - t8:.1f} s")
    t5 = time.perf_counter()
    dra = check_dra(dev, card, errs, runs=3)
    print(f"DRA phase {time.perf_counter() - t5:.1f} s")
    t3 = time.perf_counter()
    consolidation = check_consolidation(dev, card, errs, runs=3)
    t9 = time.perf_counter()
    arms = check_consolidate_arms(dev, card, errs)
    print(f"consolidation arms phase {time.perf_counter() - t9:.1f} s")
    t4 = time.perf_counter()
    sharded = check_sharded(dev, card, errs)
    t6 = time.perf_counter()
    operator = check_operator(dev, card, errs, max_ticks=OPERATOR_RUN_TICKS)
    t7 = time.perf_counter()
    serving = check_serving(dev, card, errs)
    print(f"hybrid phase {t2 - t1:.1f} s, provisioner phase {t8 - t2:.1f} s, "
          f"consolidation phase {t9 - t3:.1f} s, meshed phase {t6 - t4:.1f} s, "
          f"operator phase {t7 - t6:.1f} s, serving phase {time.perf_counter() - t7:.1f} s")
    dense = check_dense_pack(dev)
    print(f"dense pack {HEADLINE} == plain == JAX takes: launches {dense['launches']}; "
          f"{dense['ms']:.4f} ms (K1 + K2, CUDA events), {dense['plain_ms']:.4f} ms plain, "
          f"bound {dense['bound_ms']:.5f} ms ({dense['bound_by']})")

    chains = sorted(p.stem for p in (FIXTURES / "chains").glob("*.npz"))
    expect(CHURN in chains, "headline churn chain missing")
    runs = {}
    for name in chains:
        t1 = time.perf_counter()
        runs[name] = drive_chain(name, dev)
        check_chain(runs[name], dev, errs)
        modes = [(s["mode"], s["reject"]) for s in runs[name]["steps"]]
        print(f"delta path {name}: modes {modes}, launches per step {[s['counts'] for s in runs[name]['steps']]} "
              f"== reference; K4 and delta K1-K3 == plain == JAX ({time.perf_counter() - t1:.1f} s)")
    check_recredit_cases(dev, errs)
    churn = runs[CHURN]
    delta_launches = churn["totals"]
    expect(all(s["mode"] == "delta" for s in churn["steps"][1:]), "the churn chain left the delta path")

    problem, _ref = load_npz(FIXTURES / f"{HEADLINE}.npz")
    solver = GPUSolver(dev)
    e2e = []
    for _ in range(6):
        reset_bucket_highwater()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = solver.solve_encoded(problem)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t1)
        expect(res.errors == [] and res.n_placed == problem.n_pods, "timed solve_encoded run failed validation")
        solver = GPUSolver(dev)  # a fresh solver: every run is a full solve
    e2e_s = statistics.median(e2e[1:])
    print(f"solve_encoded {HEADLINE}: median of 5 warm runs {e2e_s * 1e3:.3f} ms, "
          f"{problem.n_pods / e2e_s:.1f} pods/s (runs ms: {[round(x * 1e3, 3) for x in e2e]})")

    parts = host_breakdown(problem, dev)
    print("stages ms (median of 5, synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    delta = time_delta(churn, dev)
    print(f"delta solve_encoded {CHURN} step 1 ({delta['n_pods']} pods, {delta['n_added']} added, W={delta['W']}): "
          f"median of 5 {delta['delta_ms']:.3f} ms vs full solve of the same problem {delta['full_ms']:.3f} ms "
          f"(runs ms: delta {[round(x, 3) for x in delta['delta_runs']]}, "
          f"full {[round(x, 3) for x in delta['full_runs']]})")
    print("delta stages ms (median of 5, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in delta["delta_stages"].items()))
    print("full stages ms, same problem (median of 5, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in delta["full_stages"].items()))
    for k, v in delta["delta_kernels_ms"].items():
        print(f"time delta {k} at {CHURN} step 1: {v['ms']:.4f} ms kernel, {v['plain_ms']:.4f} ms plain, "
              f"bound {v['bound_ms']:.5f} ms ({v['bound_by']}), library {v['library_ms']}"
              + (f"; graph-replayed (device only) {v['graph_ms']:.4f} ms" if "graph_ms" in v else ""))
    delta_k2 = delta["delta_kernels_ms"]["pack_scan"]
    delta_k2["place_calls"] = delta["delta_place_calls"]
    delta_k2["us_per_place"] = delta_k2["ms"] * 1e3 / delta_k2["place_calls"]

    check_proposer_kernels(dev, errs)
    cons_runs = drive_proposers(dev)
    cons_runs["fleet_5000_round"] = consolidation["round_counts"]
    cons_runs.update({f"fleet_{ARMS_NODES}_pass_lp_{arm}": arms[arm]["launches"] for arm in ARMS})
    caps = check_caps(dev, errs)
    cons_launches = {k: sum(c.get(k, 0) for c in cons_runs.values()) for k in build.LAUNCHES}
    proposers = time_proposers(dev)

    for name in names:
        t1 = time.perf_counter()
        info = check_perpod(name, dev, errs)
        print(f"per-pod kernels == plain == JAX reference: {name} P={info['P']} N={info['N']} placed {info['placed']} "
              f"open {info['open']}, {info['errors']} validation errors == reference "
              f"({time.perf_counter() - t1:.1f} s)")
    regimes = check_perpod_regimes(dev, errs)
    print(f"per-pod K8 == plain on the synthetic problems around the warp's reach: "
          + ", ".join(f"{k} open {v['first_open']} -> {v['final_open']}" for k, v in regimes.items())
          + f" (reach {next(iter(regimes.values()))['reach']})")
    perpod_runs = {name: drive_perpod(name, dev) for name in (HEADLINE, HEADLINE_AFF)}
    perpod = time_perpod(dev)

    rows = time_headline(dev, launches, errs)
    rows[0].update(perpod["feasibility_pods"])
    k1_sites_ms = time_k1_sites(dev, churn)
    rows[0].update(graph_ms=k1_sites_ms[HEADLINE]["graph_ms"], sites=k1_sites_ms)
    for name, v in k1_sites_ms.items():
        print(f"time feasibility at {name} (B={v['B']}, Nrows={v['Nrows']}, K={v['K']}, Words={v['Words']}, "
              f"R={v['R']}): {v['ms']:.4f} ms eager, {v['graph_ms']:.4f} ms graph-replayed (device only), bound "
              f"{v['bound_ms']:.5f} ms ({v['bound_by']}); empty launch {v['empty_ms']:.4f} ms eager, "
              f"{v['empty_graph_ms']:.4f} ms graph-replayed")
    k3d = delta["delta_kernels_ms"]["sparsify"]
    rows[2].update(delta_ms=k3d["ms"], delta_graph_ms=k3d["graph_ms"], delta_library_ms=k3d["library_ms"],
                   delta_bound_ms=k3d["bound_ms"])
    k2 = rows[1]
    k2.update(delta_ms=delta_k2["ms"], delta_place_calls=delta_k2["place_calls"], delta_us_per_place=delta_k2["us_per_place"])
    print(f"K2 per place() call: {HEADLINE} {k2['us_per_place']:.2f} us ({k2['place_calls']} calls, {k2['ms']:.4f} ms), "
          f"{HEADLINE_AFF} {k2['aff_us_per_place']:.2f} us ({k2['aff_place_calls']} calls, {k2['aff_ms']:.4f} ms), "
          f"{CHURN} step 1 {k2['delta_us_per_place']:.2f} us ({k2['delta_place_calls']} calls, {k2['delta_ms']:.4f} ms), "
          f"{FLEET} {k2['fleet_us_per_place']:.2f} us ({k2['fleet_place_calls']} calls, {k2['fleet_ms']:.4f} ms), "
          f"{FLEET_BIG} {k2['fleet_big_us_per_place']:.2f} us ({k2['fleet_big_place_calls']} calls, "
          f"{k2['fleet_big_ms']:.4f} ms)")
    rows.append(time_recredit(churn, delta_launches, errs))
    rows += time_consolidation(dev, cons_launches, errs, arms["anneal"]["k7"])
    rows.append(kernel_row(perpod["perpod_pack"], perpod_runs[HEADLINE], errs))
    rows[-1].update(fleet_ms=perpod["perpod_pack"]["fleet_ms"], fleet_big_ms=perpod["perpod_pack"]["fleet_big_ms"])
    rows += sharded_rows(sharded, errs)
    for r in rows:
        print(f"time {r['name']}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), library {r['library_ms']}"
              + (f"; graph-replayed (device only) {r['graph_ms']:.4f} ms" if "graph_ms" in r else ""))
    print(f"K5 d: max |kernel - plain| {errs['globalpack']:.3g}, max |kernel - JAX| {errs['globalpack_vs_jax']:.3g}")
    k1p = perpod["feasibility_pods"]
    print(f"time feasibility over the {HEADLINE} pods: {k1p['pods_ms']:.4f} ms kernel, {k1p['pods_plain_ms']:.4f} ms "
          f"plain, bound {k1p['pods_bound_ms']:.5f} ms ({k1p['pods_bound_by']})")
    print(f"greedy_pack_encoded {HEADLINE}: median of 5 warm calls {perpod['entry_ms']:.3f} ms "
          f"(runs ms: {[round(x, 3) for x in perpod['entry_runs']]}); stages ms (median of 5, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in perpod["entry_stages"].items()))
    return {"kernels": rows, "caps": caps, "paths": {"full": launches, "full_affinity": aff_launches, "delta": delta_launches,
                                       "dense": dense["launches"], "consolidation": cons_runs, "perpod": perpod_runs,
                                       "snapshot": snapshot["full_counts"], "snapshot_delta": snapshot["delta_counts"],
                                       **dict(zip(("solve", "solve_resubmit", "solve_delta", "solve_delta_1pod"), solve["paths"])),
                                       **dict(zip(("hybrid", "hybrid_resubmit", "hybrid_delta_1pod", "hybrid_delta_removal",
                                                   "hybrid_residual_gone"), hybrid["paths"])),
                                       "provision": provision["path"], "meshed": sharded["paths"],
                                       "wide": dict(zip(("cold", "resubmit", "delta_1pod"), wide["paths"])),
                                       **dict(zip(("dra_cold", "dra_delta_1pod", "dra_provision"), dra["paths"])),
                                       "consolidation_reconcile": consolidation["pass_counts"],
                                       "consolidate_arms": {arm: v["launches"] for arm, v in arms.items()},
                                       "operator": operator["launches"], "serving_churn": serving["churn"]["launches"],
                                       "serving_repack": serving["churn"]["repack_launches"],
                                       "serving_fleet": serving["fleet"]["launches"]},
            "proposers_ms": {k: v["ms"] for k, v in proposers.items()}, "perpod_entry_ms": perpod["entry_ms"],
            "snapshot_ms": {k: snapshot[k] for k in ("encode_ms", "delta_encode_ms", "e2e_ms", "pods_per_s")},
            "solve_ms": {**solve["ms"], "decode": solve["decode_ms"], "stages": solve["stages"]},
            "hybrid_ms": {**hybrid["ms"], "stages": hybrid["stages"], "provision": provision["ms"],
                          "provision_split": provision["split"], "provision_stages": provision["stages"]},
            "observability": observability, "dra_ms": {"cold": dra["ms"], "stages": dra["stages"]},
            "reqtable": {"wide": dict(zip(("cold", "resubmit", "delta_1pod"), wide["table"])),
                         "ffd_filters": wide["ffd_filters"]},
            "wide_ms": {"cold": wide["ms"], "stages": wide["stages"], "ffd": wide["ffd_ms"], "ffd_runs": wide["ffd_runs"]},
            "consolidation_ms": {"decision": consolidation["ms"], "stages": consolidation["stages"],
                                 "reconcile": consolidation["pass_ms"], "reconcile_split": consolidation["pass_split"],
                                 "fleet_build_s": consolidation["build_s"], "probes": consolidation["probes"],
                                 "arms": {arm: {k: v[k] for k in v if k != "launches"} for arm, v in arms.items()}},
            "operator_ticks": operator["ticks"], "serving": serving}


def run_dra(dev, card: str) -> dict:
    """The DRA phase alone (`--only dra`), for a quick check of the slice;
    the whole run is `run`."""
    errs = {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0, "recredit": 0.0}
    t1 = time.perf_counter()
    out = check_dra(dev, card, errs)
    print(f"DRA phase {time.perf_counter() - t1:.1f} s")
    return {"dra": out, "errs": errs}


def run_wide(dev, card: str) -> dict:
    """The wide phase alone (`--only wide`)."""
    errs = {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0, "recredit": 0.0}
    t1 = time.perf_counter()
    out = check_wide(dev, card, errs)
    print(f"wide phase {time.perf_counter() - t1:.1f} s")
    return {"wide": out, "errs": errs}


def run_operator(dev, card: str) -> dict:
    """The operator phase alone (`--only operator`)."""
    errs = {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0, "recredit": 0.0, "globalpack": 0.0,
            "score_subsets": 0.0}
    t1 = time.perf_counter()
    out = check_operator(dev, card, errs)
    print(f"operator phase {time.perf_counter() - t1:.1f} s")
    return {"operator": out, "errs": errs}


def run_serving(dev, card: str) -> dict:
    """The serving phase alone (`--only serving`)."""
    errs = {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0, "recredit": 0.0, "globalpack": 0.0,
            "score_subsets": 0.0}
    t1 = time.perf_counter()
    out = check_serving(dev, card, errs)
    print(f"serving phase {time.perf_counter() - t1:.1f} s")
    return {"serving": out, "errs": errs}


def run_arms(dev, card: str) -> dict:
    """The consolidation arms' phase alone (`--only arms`)."""
    errs = {"anneal_pack": 0.0, "anneal": 0.0}
    t1 = time.perf_counter()
    out = check_consolidate_arms(dev, card, errs)
    print(f"consolidation arms phase {time.perf_counter() - t1:.1f} s")
    return {"arms": out, "errs": errs}


def host_cpu() -> str:
    """The host CPU's model (the host stages' times depend on it): the first
    of /proc/cpuinfo's model fields that is present, else the machine type."""
    import platform

    try:
        info = dict(line.split(":", 1) for line in Path("/proc/cpuinfo").read_text().splitlines() if ":" in line)
    except OSError:
        info = {}
    info = {k.strip(): v.strip() for k, v in info.items()}
    for key in ("model name", "Model", "cpu model", "CPU part"):
        if info.get(key):
            return f"{info[key]} ({platform.machine()})"
    return platform.machine() or "unknown CPU"


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port on one GPU.")
    ap.add_argument("--only", choices=("dra", "wide", "operator", "serving", "arms"),
                    help="run only this phase (after the build)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "karpenter_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (karpenter_tpu_torch/ not found)", file=sys.stderr)
        return 2
    # the fixtures' reference outputs were made with plain shape bucketing
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    sys.path.insert(0, str(ROOT))
    from karpenter_tpu_torch.kernels import build

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    print(f"card: {card}")
    print(f"host: {host_cpu()}, {os.cpu_count()} logical CPUs")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.BUILD_INFO.get('path', 'cached')})")
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if line.startswith("== ") or any(w in line for w in ("Compiling entry", "registers", "stack frame", "spill")):
            print("ptxas:", line.strip())
    from karpenter_tpu_torch import native

    t0 = time.perf_counter()
    native.build()  # the residual FFD's C++ requirement table (a host kernel, g++)
    print(f"requirement table build: {time.perf_counter() - t0:.1f} s ({native.lib_dir()})")

    line = {"dra": run_dra, "wide": run_wide, "operator": run_operator, "serving": run_serving, "arms": run_arms,
            None: run}[args.only](dev, card)
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s (the kernels' build included)")
    print(json.dumps(line))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
