#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`karpenter_tpu_torch`) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It prints the card's name and power limit, builds the three CUDA kernels
from `karpenter_tpu_torch/kernels/csrc/`, and for every fixture in
`karpenter_tpu_torch/fixtures/` holds each kernel against its plain PyTorch
version on the card (`torch.equal`: integer, bool and identically computed
f32 outputs) and the pack's flat output and final carry against the JAX
reference stored in the fixture. It then drives the main path,
`GPUSolver().solve_encoded`, on the headline problem (5000 pods x 100
instance types) and its required-affinity variant with every launch count
set to 0 just before and read just after, and requires 0 validation errors,
every pod placed and the stored JAX assignment. Last it times each kernel,
its plain version and the library yardstick with CUDA events at the
headline shape, and the end-to-end solve.

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
from dataclasses import fields
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADLINE = "headline_5000x100"
HEADLINE_AFF = "headline_aff_5000x100"
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# non-tensor-core f32 rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
REPLACES = {
    "feasibility": "karpenter_tpu/models/scheduler_model.py:436",
    "pack_scan": "karpenter_tpu/models/scheduler_model_grouped.py:1028",
    "sparsify": "karpenter_tpu/models/scheduler_model_grouped.py:1012",
}


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
    problem, ref = load_npz(ROOT / "karpenter_tpu_torch" / "fixtures" / f"{name}.npz")
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
    names = ("slot_basis", "slot_rem", "slot_zoneset", "slot_rank", "counts_zone", "counts_host", "open_count",
             "port_any", "port_wild", "port_spec")
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

    problem, ref = load_npz(ROOT / "karpenter_tpu_torch" / "fixtures" / f"{name}.npz")
    solver = GPUSolver()
    reset_bucket_highwater()
    build.reset_launches()
    res = solver.solve_encoded(problem)
    counts = dict(build.LAUNCHES)
    expect(res.errors == [], f"{name}: validation errors {res.errors}")
    expect(res.n_placed == problem.n_pods, f"{name}: placed {res.n_placed} of {problem.n_pods}")
    expect(bool((res.assignment == ref["ref_assignment"]).all()), f"{name}: assignment differs from the JAX reference")
    expect(res.open_count == int(ref["ref_open_count"]), f"{name}: open count differs from the JAX reference")
    for k, v in counts.items():
        expect(v > 0, f"{name}: kernel {k} was not launched on the main path")
    return counts, dict(placed=res.n_placed, pods=problem.n_pods, open=res.open_count, items=res.item_info["n_items"])


def time_headline(dev, launches: dict, errs: dict) -> list:
    """CUDA-event times of each kernel, its plain version and the library
    yardstick at the headline shape, with the bound of each."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import feasibility, feasibility_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan, pack_scan_plain
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs, flat_outputs_plain
    from karpenter_tpu_torch.models.scheduler_model_grouped import initial_state

    problem, ref, t, items, nnz_cap = prepare(HEADLINE, dev)
    W, R = items.item_req.shape
    Nrows, K = t.row_labels.shape
    N = t.n_slots
    D = t.counts_dom_init.shape[1]
    compat, key = feasibility(t, items)
    takes, left, state = pack_scan(t, items, compat, key, n_slots=N)
    flat = flat_outputs(takes, left, state[0], state[2], state[6], nnz_cap)
    init = initial_state(t, N)
    torch.cuda.synchronize()
    rows = []

    # K1
    k1_in = nbytes(t.row_labels, t.row_taint_class, t.row_alloc, t.row_pool_rank, items.item_mask,
                   items.item_taint_ok, items.item_req)
    k1_bytes = k1_in + nbytes(compat, key)
    k1_ops = W * Nrows * (3 * K + 3 * R + 4)
    rows.append(dict(
        name="feasibility", ms=cuda_ms(lambda: feasibility(t, items), 20),
        plain_ms=cuda_ms(lambda: feasibility_plain(t, items), 5), library_ms=None,
        bytes=k1_bytes, ops=k1_ops,
    ))
    # K2: the carry, the item and row inputs read once; takes, leftovers and
    # the final carry written once. Operations counted from this run's
    # place() calls: each touches every slot with ~(3R + 3DR + 12) f32/int ops.
    carry = list(init[:7]) + list(init[7])
    t_in = nbytes(t.row_alloc, t.row_pool_rank, t.rank_domset, t.rank_dom_cap, t.dom_key_of, t.group_kind,
                  t.group_skew, t.group_dom_key, t.group_min_domains, t.group_registered, t.row_port_any,
                  t.row_port_wild, t.row_port_spec)
    i_in = nbytes(items.item_req, items.item_dom_allowed, items.item_restrict, items.item_member, items.item_owner,
                  items.item_count, items.item_port_any, items.item_port_wild, items.item_port_spec,
                  items.item_host_blocked, compat, key)
    k2_bytes = t_in + i_in + 2 * nbytes(*carry) + nbytes(takes, left)
    n_place = place_calls(t, items)
    k2_ops = n_place * N * (3 * R + 3 * D * R + 12)
    rows.append(dict(
        name="pack_scan", ms=cuda_ms(lambda: pack_scan(t, items, compat, key, n_slots=N), 3),
        plain_ms=cuda_ms(lambda: pack_scan_plain(t, items, n_slots=N, precomputed=(compat, key)), 1, rounds=2),
        library_ms=None, bytes=k2_bytes, ops=k2_ops,
    ))
    # K3: the take matrix and the tail read once, the flat vector written once
    k3_bytes = nbytes(takes, left, state[0], state[2], state[6]) + nbytes(flat)
    rows.append(dict(
        name="sparsify",
        ms=cuda_ms(lambda: flat_outputs(takes, left, state[0], state[2], state[6], nnz_cap), 20),
        plain_ms=cuda_ms(lambda: flat_outputs_plain(takes, left, state[0], state[2], state[6], nnz_cap), 5),
        library_ms=cuda_ms(lambda: torch.nonzero(takes), 20),
        bytes=k3_bytes, ops=W * N,
    ))
    src = {"feasibility": "feasibility.cu", "pack_scan": "pack_scan.cu", "sparsify": "sparsify.cu"}
    out = []
    for r in rows:
        t_bytes = r["bytes"] / PEAK_BYTES_S * 1e3
        t_ops = r["ops"] / PEAK_F32_S * 1e3
        out.append(dict(
            name=r["name"], route="cuda", source=f"karpenter_tpu_torch/kernels/csrc/{src[r['name']]}",
            replaces=REPLACES[r["name"]], launches=launches[r["name"]], max_abs_err=errs[r["name"]],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=r["library_ms"],
        ))
    return out


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
    from karpenter_tpu_torch.models.scheduler_model import reset_bucket_highwater
    from karpenter_tpu_torch.solver.encoded import load_npz
    from karpenter_tpu_torch.solver.gpu import GPUSolver

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
        if "registers" in line or "stack frame" in line or "spill" in line.lower():
            print("ptxas:", line.strip())

    names = sorted(p.stem for p in (ROOT / "karpenter_tpu_torch" / "fixtures").glob("*.npz"))
    expect(HEADLINE in names and HEADLINE_AFF in names, "headline fixtures missing")
    errs = {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0}
    for name in names:
        t1 = time.perf_counter()
        info = check_kernels(name, dev)
        errs = {k: max(v, info["errs"][k]) for k, v in errs.items()}
        print(f"kernels == plain == JAX reference: {name} W={info['W']} N={info['N']} ({time.perf_counter() - t1:.1f} s)")

    launches, summary = run_main_path(HEADLINE, dev)
    print(f"main path {HEADLINE}: {summary} launches {launches}")
    aff_launches, aff_summary = run_main_path(HEADLINE_AFF, dev)
    print(f"main path {HEADLINE_AFF}: {aff_summary} launches {aff_launches}")

    problem, _ref = load_npz(ROOT / "karpenter_tpu_torch" / "fixtures" / f"{HEADLINE}.npz")
    solver = GPUSolver()
    e2e = []
    for _ in range(6):
        reset_bucket_highwater()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = solver.solve_encoded(problem)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t1)
        expect(res.errors == [] and res.n_placed == problem.n_pods, "timed solve_encoded run failed validation")
    e2e_s = statistics.median(e2e[1:])
    print(f"solve_encoded {HEADLINE}: median of 5 warm runs {e2e_s * 1e3:.3f} ms, "
          f"{problem.n_pods / e2e_s:.1f} pods/s (runs ms: {[round(x * 1e3, 3) for x in e2e]})")

    parts = host_breakdown(problem, dev)
    print("stages ms (median of 5, synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    rows = time_headline(dev, launches, errs)
    for r in rows:
        print(f"time {r['name']}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), library {r['library_ms']}")
    print(json.dumps({"kernels": rows}))
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
