#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`karpenter_tpu_torch`) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It prints the card's name and power limit, builds the eight CUDA kernels
from `karpenter_tpu_torch/kernels/csrc/`, and for every fixture in
`karpenter_tpu_torch/fixtures/` holds each pack kernel against its plain
PyTorch version on the card (`torch.equal`: integer, bool and identically
computed f32 outputs) and the pack's flat output and final carry against the
JAX reference stored in the fixture. It then drives the full path,
`GPUSolver().solve_encoded`, on the headline problem (5000 pods x 100
instance types) and its required-affinity variant with every launch count
set to 0 just before and read just after, and requires 0 validation errors,
every pod placed and the stored JAX assignment; and the dense pack
(`greedy_pack_grouped`) against its plain version and the JAX takes.

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
driven end to end on its fixture (`propose_subsets_lp` on the 5000-node
fleet, `propose_subsets_global` on the 5000-node spot/on-demand fleet
without and with 200 pending pods, `propose_subsets` on the 256-node anneal
fleet; each from the JAX inits, and the global one also through
`GPUSolver().global_repack_plan_encoded` with its own generator), the counts
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
host's time to issue each call.

Output: a `kernels` JSON line, the card line, then as the last line
`{"ok": true, "device": {...}}`. Any mismatch or exception exits non-zero.
Without a CUDA device, or without the rest of the repository beside it, it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import fields
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
SOURCES = {"feasibility": "feasibility.cu", "pack_scan": "pack_scan.cu", "sparsify": "sparsify.cu",
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
    expect(torch.equal(key, key_p), f"{name}: K1 key differs from plain")

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


def k1_cost(t, items, compat, key) -> tuple[int, int]:
    """(bytes K1 must move, operations it must do): inputs read once,
    outputs written once."""
    W, R = items.item_req.shape
    Nrows, K = t.row_labels.shape
    k1_in = nbytes(t.row_labels, t.row_taint_class, t.row_alloc, t.row_pool_rank, items.item_mask,
                   items.item_taint_ok, items.item_req)
    return k1_in + nbytes(compat, key), W * Nrows * (3 * K + 3 * R + 4)


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


@contextmanager
def chain_env(ref):
    """The environment a chain was made under (its `env` entries)."""
    saved = dict(os.environ)
    for entry in ref["env"]:
        key, value = str(entry).split("=", 1)
        os.environ[key] = value
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


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
            expect(torch.equal(compat, compat_p) and torch.equal(key, key_p), f"{what}: delta K1 differs from plain")
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


def check_consolidation(dev, errs) -> None:
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
        propose_subsets,
        propose_subsets_global,
        propose_subsets_lp,
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
            out = propose_subsets_lp(problem, dev, inits=inits)
        else:
            out, info = propose_subsets_global(problem, dev, inits=inits)
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
    expect(len(out) > 0 and info["rounded"] > 0, "global_repack_plan_encoded proposed nothing")
    runs["global_repack_plan_encoded"] = counts
    print(f"main path GPUSolver.global_repack_plan_encoded {CONS_PENDING} (torch.Generator inits): "
          f"{len(out)} proposals, info {info}, launches {counts}")
    problem, ref = cons_load(CONS_ANNEAL)
    build.reset_launches()
    out = propose_subsets(problem, dev, streams=(ref["ref_x0"], ref["ref_flips"], ref["ref_u"]))
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


def time_consolidation(dev, launches: dict, errs: dict) -> list:
    """The `kernels` rows of K5-K7 at the 5000-node shapes (CUDA events)."""
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
    gen = torch.Generator(device=dev).manual_seed(0)
    s8 = draw_anneal_streams(t8.node_price.shape[0], gen)
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
    return out


def time_proposers(dev, runs: int = 5) -> dict:
    """Host-clock ms (device synchronised) of the LP and global proposers on
    their 5000-node fleets: median of `runs` warm calls, and the median of
    each stage over `runs` staged calls."""
    import torch

    from karpenter_tpu_torch.solver.consolidation import (
        propose_subsets_global,
        propose_subsets_lp,
        reference_inits,
    )

    out = {}
    for name, fn in ((CONS_LP, propose_subsets_lp), (CONS_GLOBAL, propose_subsets_global),
                     (CONS_PENDING, propose_subsets_global)):
        problem, ref = cons_load(name)
        inits = reference_inits(problem, ref)
        wall, stages = [], []
        for _ in range(runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(problem, dev, inits=inits)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            st: dict = {}
            fn(problem, dev, inits=inits, stages=st)
            stages.append(st)
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
        expect(all(torch.equal(a, b) for a, b in zip((compat, key), feasibility_plain(t, items))),
               f"{name}: K1 differs from plain")
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
        row_port_spec=ports, dom_keys=(2, -1), n_existing=s["n_ex"], n_slots=s["N"],
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
    """K8 against its plain version (the five outputs and the whole carry)
    on `PERPOD_REGIME_CASES`, which stay below, cross and start past the
    warp's reach; returns each case's first and final open-slot count."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import compat_and_key
    from karpenter_tpu_torch.kernels.perpod_pack import WARP_REACH, perpod_pack, perpod_pack_plain

    out = {}
    for name, (seed, n_ex, N, P) in PERPOD_REGIME_CASES.items():
        t, pods = perpod_tensors(perpod_regime_arrays(seed, n_ex, N, P), dev)
        compat, key = compat_and_key(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
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
    expect(torch.equal(compat, compat_p) and torch.equal(key, key_p), f"{name}: K1 over the pods differs from plain")
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
    errs = {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0, "recredit": 0.0, "globalpack": 0.0,
            "score_subsets": 0.0, "anneal_pack": 0.0, "anneal": 0.0, "perpod_pack": 0.0}
    for name in names:
        t1 = time.perf_counter()
        info = check_kernels(name, dev)
        errs = {k: max(v, info["errs"].get(k, 0.0)) for k, v in errs.items()}
        print(f"kernels == plain == JAX reference: {name} W={info['W']} N={info['N']} ({time.perf_counter() - t1:.1f} s)")

    launches, summary = run_main_path(HEADLINE, dev)
    print(f"main path {HEADLINE}: {summary} launches {launches}")
    aff_launches, aff_summary = run_main_path(HEADLINE_AFF, dev)
    print(f"main path {HEADLINE_AFF}: {aff_summary} launches {aff_launches}")
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

    check_consolidation(dev, errs)
    cons_runs = drive_proposers(dev)
    caps = check_caps(dev, errs)
    cons_launches = {k: sum(c[k] for c in cons_runs.values()) for k in build.LAUNCHES}
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
    rows += time_consolidation(dev, cons_launches, errs)
    rows.append(kernel_row(perpod["perpod_pack"], perpod_runs[HEADLINE], errs))
    rows[-1].update(fleet_ms=perpod["perpod_pack"]["fleet_ms"], fleet_big_ms=perpod["perpod_pack"]["fleet_big_ms"])
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
                                       "dense": dense["launches"], "consolidation": cons_runs, "perpod": perpod_runs},
            "proposers_ms": {k: v["ms"] for k, v in proposers.items()}, "perpod_entry_ms": perpod["entry_ms"]}


def main() -> int:
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.BUILD_INFO.get('path', 'cached')})")
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if line.startswith("== ") or any(w in line for w in ("Compiling entry", "registers", "stack frame", "spill")):
            print("ptxas:", line.strip())

    line = run(dev, card)
    print(json.dumps(line))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
