#!/usr/bin/env python3
"""Time the port's kernels of two or more checkouts side by side, on one card.

Run on a machine with a CUDA card, from the repository root, with each
checkout unpacked under `build/` (for example the parent commit):

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 tools/kernel_ab.py build/parent .

Each checkout runs in its own process (it builds its own kernels into its own
`build/`), in the order given and then in reverse (A, B, B, A), so drift of
the card's clocks shows as a difference between the two runs of one tree.
Each run loads the fixtures with that checkout's `chip_smoke.py` and times,
with CUDA events (median of 5 rounds after a warm-up call), the kernel
wrappers alone: K2 `pack_scan` on the two headlines and the two existing
fleets, K3 `flat_outputs` at the headline and at the headline churn chain's
delta step (`chip_smoke.drive_chain`), eagerly and from a replayed CUDA
graph (device time), K8 `perpod_pack` at the headline and the two existing
fleets, K5 `globalpack` at `lp_5000` (Qp
= R = 4) and at two shapes of the same fleet that other builds of the
kernel take (R = 5 and Qp = 8, from this checkout's
`chip_smoke.k5_widened`), each beside its plain version's d, K6
`score_subsets` on that proposer's rows, K7 `anneal` on `anneal_256` and at
the 5000-node fleet's Np = 8192, and the three proposers at 5000 nodes end to
end and by stage (`chip_smoke.time_proposers`; "K6 stage" sums the stages
named "K6 ..."). K1 `compat_and_key` is timed at its call sites
(`chip_smoke.k1_sites` of this checkout: both headlines' items, the churn
step's, the headline's 5000 pods, `existing_fleet_3800` and `caps_wide`),
eagerly and graph-replayed, beside an empty kernel's launch where the tree
has one (`build.empty_launch`). A tree whose tensors carry no `forced_keys`
(before K1's wrapper stopped copying the forced-key mask from the host on
every call, which cannot be captured in a graph) is graph-timed through its
`kt_feasibility` called directly, with the mask and outputs made before the
capture. It prints one JSON line per run and one with the medians per tree.

    python3 tools/kernel_ab.py --only k1 build/parent .   # K1 and the empty launch alone
    python3 tools/kernel_ab.py --only empty .             # the empty launch alone
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def current_chip_smoke():
    """This checkout's `chip_smoke` (the one beside this script), whatever
    tree `one` imports."""
    spec = importlib.util.spec_from_file_location("chip_smoke_current", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k1_direct(build, t, masks, taints_ok, req, dev):
    """A call of the tree's `kt_feasibility` without its wrapper, for a tree
    whose wrapper copies the forced-key mask from the host on every call:
    the mask and the outputs are made once, here, and the call checked
    against the wrapper's outputs."""
    import torch

    from karpenter_tpu_torch.kernels.feasibility import compat_and_key

    B, K, Words = masks.shape
    Nrows, R = t.row_alloc.shape
    C = taints_ok.shape[1]
    forced = torch.zeros(K, dtype=torch.bool)
    for kk in t.dom_keys:
        if 0 <= kk < K:
            forced[kk] = True
    keep = [t.row_labels, t.row_taint_class, t.row_alloc, t.row_pool_rank, masks, taints_ok, req, forced.to(dev)]
    compat = torch.empty((B, Nrows), dtype=torch.bool, device=dev)
    key = torch.empty((B, Nrows), dtype=torch.float32, device=dev)
    lib = build.lib()

    def call():
        rc = lib.kt_feasibility(*[x.data_ptr() for x in keep], B, Nrows, K, Words, C, R, compat.data_ptr(),
                                key.data_ptr(), build.stream_ptr(dev))
        build.check(rc, "feasibility")

    call()
    want = compat_and_key(t, masks, taints_ok, req)
    torch.cuda.synchronize()
    assert torch.equal(compat, want[0]) and torch.equal(key.view(torch.int32), want[1].view(torch.int32))
    return call


def time_k1(cs, build, dev, churn) -> dict:
    """K1 at its call sites, eagerly and graph-replayed, with its bound; the
    empty launch after each where the tree has one."""
    import types

    from karpenter_tpu_torch.kernels.feasibility import compat_and_key

    cur = current_chip_smoke()
    out = {}
    for name, (t, *args) in cur.k1_sites(dev, churn).items():
        compat, key = compat_and_key(t, *args)
        n_bytes, ops = cur.k1_cost(t, types.SimpleNamespace(item_mask=args[0], item_taint_ok=args[1], item_req=args[2]),
                                   compat, key)
        out[f"K1 {name} bound"] = cur.bound_of(n_bytes, ops)[0]
        out[f"K1 {name}"] = cur.cuda_ms(lambda: compat_and_key(t, *args), 20)
        direct = (lambda: compat_and_key(t, *args)) if hasattr(t, "forced_keys") else k1_direct(build, t, *args, dev)
        out[f"K1 {name} graph"] = cur.graph_ms(direct, 20)
        if hasattr(build, "empty_launch"):
            out[f"empty after {name}"] = cur.cuda_ms(lambda: build.empty_launch(dev), 20)
            out[f"empty after {name} graph"] = cur.graph_ms(lambda: build.empty_launch(dev), 20)
    return out


def one(tree: str, only: str = "") -> dict:
    """The times of the kernels of the checkout at `tree` (this process);
    `only` = "k1" times K1 and the empty launch alone, "empty" the empty
    launch alone."""
    tree_path = Path(tree).resolve()
    sys.path.insert(0, str(tree_path))
    os.environ["KARPENTER_SOLVER_BUCKET"] = "0"
    import numpy as np
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.anneal import anneal
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, feasibility
    from karpenter_tpu_torch.kernels.globalpack import globalpack, globalpack_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan
    from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack
    from karpenter_tpu_torch.kernels.score_subsets import score_subsets
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs
    from karpenter_tpu_torch.models.consolidation_model import draw_anneal_streams
    from karpenter_tpu_torch.models.scheduler_model_grouped import delta_nnz_cap
    from karpenter_tpu_torch.solver.consolidation import lp_ladder, reference_inits, tensors_from_problem

    assert Path(build.__file__).resolve().is_relative_to(tree_path), build.__file__
    dev = torch.device("cuda")
    build.lib()
    out = {"tree": tree}
    if only == "empty":
        cur = current_chip_smoke()
        return out | {"empty": cur.cuda_ms(lambda: build.empty_launch(dev), 20),
                      "empty graph": cur.graph_ms(lambda: build.empty_launch(dev), 20)}
    churn = cs.drive_chain(cs.CHURN, dev)
    out.update(time_k1(cs, build, dev, churn))
    if only == "k1":
        return out
    for name in (cs.HEADLINE, cs.HEADLINE_AFF, cs.FLEET, cs.FLEET_BIG):
        _problem, _ref, t, items, _nnz = cs.prepare(name, dev)
        compat, key = feasibility(t, items)
        out[f"pack_scan {name}"] = cs.cuda_ms(lambda: pack_scan(t, items, compat, key, n_slots=t.n_slots), 3)
        if name == cs.HEADLINE:
            takes, left, st = pack_scan(t, items, compat, key, n_slots=t.n_slots)
            k3 = (takes, left, st[0], st[2], st[6], _nnz)
            out["sparsify headline"] = cs.cuda_ms(lambda: flat_outputs(*k3), 20)
            out["sparsify headline graph"] = cs.graph_ms(lambda: flat_outputs(*k3), 20)
            out["nonzero headline"] = cs.cuda_ms(lambda: torch.nonzero(takes), 20)
    state, t, items, n_added = churn["steps"][1]["seen"]["dp"]
    compat, key = feasibility(t, items)
    takes, left, st = pack_scan(t, items, compat, key, n_slots=t.n_slots, init_state=state)
    k3 = (takes, left, st[0], st[2], st[6], delta_nnz_cap(n_added))
    out["sparsify churn step"] = cs.cuda_ms(lambda: flat_outputs(*k3), 20)
    out["sparsify churn step graph"] = cs.graph_ms(lambda: flat_outputs(*k3), 20)
    out["nonzero churn step"] = cs.cuda_ms(lambda: torch.nonzero(k3[0]), 20)
    for name in (cs.HEADLINE, cs.FLEET, cs.FLEET_BIG):
        _problem, _ref, t, pods = cs.perpod_load(name, dev)
        compat, key = compat_and_key(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
        out["perpod_pack" if name == cs.HEADLINE else f"perpod_pack {name}"] = cs.cuda_ms(
            lambda: perpod_pack(t, pods, compat, key), 3)
    problem, ref = cs.cons_load(cs.CONS_LP)
    t, aux = tensors_from_problem(problem, dev)
    d0, y0 = (torch.as_tensor(a, device=dev) for a in reference_inits(problem, ref))
    gp_args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0,
               int(ref["ref_n_iters"]))
    out["globalpack"] = cs.cuda_ms(lambda: globalpack(*gp_args), 3)
    for shape, args in current_chip_smoke().k5_widened(t, aux, d0, y0, int(ref["ref_n_iters"])).items():
        out[f"globalpack {shape}"] = cs.cuda_ms(lambda: globalpack(*args), 3)
        d, _ = globalpack(*args)
        d_p, _ = globalpack_plain(*args)
        out[f"globalpack {shape} max_abs_vs_plain"] = float((d - d_p).abs().max())
    _o, X, _s, _f = lp_ladder(t, aux, ref["ref_d"], problem.n)
    Xp = np.zeros((len(X) + (-len(X) % 32), X.shape[1]), bool)
    Xp[:len(X)] = X
    Xt = torch.as_tensor(Xp, device=dev)
    k6 = (t, aux["onehot"], aux["compat_nq"], aux["pend_req"], aux["pend_npods"], aux["pend_active"], Xt)
    out["score_subsets"] = cs.cuda_ms(lambda: score_subsets(*k6), 20)
    # the proposers' K6 stage (host clock, synchronised): the tree's stages
    # whose names start with "K6", summed (one stage before the split into
    # upload, kernel and download)
    for name, st in cs.time_proposers(dev).items():
        for k, v in st["stages"].items():
            out[f"proposer {name} stage {k}"] = v
        out[f"proposer {name} K6 stage"] = sum(v for k, v in st["stages"].items() if k.startswith("K6"))
        out[f"proposer {name}"] = st["ms"]
    a_problem, a_ref = cs.cons_load(cs.CONS_ANNEAL)
    ta, _ = tensors_from_problem(a_problem, dev, dense_compat=True)
    streams = [torch.as_tensor(a_ref[k], device=dev) for k in ("ref_x0", "ref_flips", "ref_u")]
    out["anneal anneal_256"] = cs.cuda_ms(lambda: anneal(ta, *streams), 5)
    t8, _ = tensors_from_problem(problem, dev, dense_compat=True)
    s8 = draw_anneal_streams(t8.node_price.shape[0], 0, dev)
    out["anneal Np=8192"] = cs.cuda_ms(lambda: anneal(t8, *s8), 2, rounds=3)
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(*sys.argv[2:4])))
        return 0
    trees = sys.argv[1:]
    only = []
    if trees[:1] == ["--only"]:
        only, trees = trees[1:2], trees[2:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    runs: dict = {tree: [] for tree in trees}
    for tree in trees + trees[::-1]:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", tree, *only],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line))
        runs[tree].append(line)
    med = {tree: {k: statistics.median(r[k] for r in rs) for k in rs[0] if k != "tree"} for tree, rs in runs.items()}
    print(json.dumps({"medians_ms": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
