#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`karpenter_tpu_torch`) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It prints the card's name and power limit, builds the four CUDA kernels
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
the stored JAX carry.

Last it times each kernel, its plain version and the library yardstick with
CUDA events at the headline shape (K4 and the delta pack at the headline
churn step), the full solve, and the delta solve beside a full solve of the
same problem, with stage breakdowns (host clock, device synchronised).

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
}
SOURCES = {"feasibility": "feasibility.cu", "pack_scan": "pack_scan.cu", "sparsify": "sparsify.cu",
           "recredit": "recredit.cu"}


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
             library_ms=cuda_ms(lambda: torch.nonzero(takes), 20)),
    ], cost


def time_headline(dev, launches: dict, errs: dict) -> list:
    """The `kernels` rows of K1-K3 at the headline shape."""
    problem, ref, t, items, nnz_cap = prepare(HEADLINE, dev)
    rows, cost = time_pack(t, items, nnz_cap)
    return [kernel_row(r | dict(bytes=cost[r["name"]][0], ops=cost[r["name"]][1]), launches, errs) for r in rows]


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
    print(f"recredit at {CHURN} step 1: K={K} padded removals ({n_valid} real), N={state[1].shape[0]}, R={R}, G={G}")
    return kernel_row(row, launches, errs)


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
                                  bound_by=bound_by)

    def med(rows):
        return {k: statistics.median(r.get(k, 0.0) for r in rows[1:]) for k in rows[-1]}

    return dict(delta_ms=statistics.median(delta_ms[1:]), full_ms=statistics.median(full_ms[1:]),
                delta_runs=delta_ms, full_runs=full_ms, delta_stages=med(delta_stages),
                full_stages=med(full_stages), delta_kernels_ms=kernels, W=int(items.item_req.shape[0]),
                n_added=int(n_added), n_pods=step.n_pods)


def run(dev, card: str) -> dict:
    """Every check and timing on `dev`; returns the `kernels` line."""
    import torch

    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.encoded import load_npz
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    names = sorted(p.stem for p in FIXTURES.glob("*.npz"))
    expect(HEADLINE in names and HEADLINE_AFF in names, "headline fixtures missing")
    errs = {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0, "recredit": 0.0}
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
              f"bound {v['bound_ms']:.5f} ms ({v['bound_by']}), library {v['library_ms']}")

    rows = time_headline(dev, launches, errs)
    rows.append(time_recredit(churn, delta_launches, errs))
    for r in rows:
        print(f"time {r['name']}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), library {r['library_ms']}")
    return {"kernels": rows, "paths": {"full": launches, "full_affinity": aff_launches, "delta": delta_launches,
                                       "dense": dense["launches"]}}


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
