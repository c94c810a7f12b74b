"""CUDA kernels against their plain versions on the card (marker `gpu`).

The kernels have no CPU form, so these tests skip where there is no CUDA
device; `python3 chip_smoke.py` runs the same comparisons at every fixture
and drives the main path. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m gpu
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.solver.encoded import load_npz
from test_torch_fixtures import FIXTURE_DIR

SMALL = ("small_multigroup", "small_existing_ports_inverse", "small_existing_affinity", "small_affinity")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    tsm.reset_bucket_highwater()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", SMALL)
def test_kernels_equal_plain_on_card(cuda_device, name):
    from karpenter_tpu_torch.kernels.feasibility import feasibility, feasibility_plain
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan, pack_scan_plain
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs, flat_outputs_plain
    from karpenter_tpu_torch.models import scheduler_model_grouped as tsg

    problem, ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, cuda_device)
    t = tsm.make_tensors(problem, cuda_device, n_slots=int(ref["ref_n_slots"]))
    compat, key = feasibility(t, items)
    assert [torch.equal(a, b) for a, b in zip((compat, key), feasibility_plain(t, items))] == [True, True]
    takes, left, state = pack_scan(t, items, compat, key, n_slots=t.n_slots)
    takes_p, left_p, state_p = pack_scan_plain(t, items, n_slots=t.n_slots, precomputed=(compat, key))
    assert torch.equal(takes, takes_p) and torch.equal(left, left_p)
    for a, b in zip(list(state[:7]) + list(state[7]), list(state_p[:7]) + list(state_p[7])):
        assert torch.equal(a, b)
    # continuing from a carry equals one pass (the delta path's contract)
    from dataclasses import fields

    cut = items.item_req.shape[0] // 2
    part = [tsg.ItemTensors(**{f.name: getattr(items, f.name)[lo:hi] for f in fields(tsg.ItemTensors)})
            for lo, hi in ((0, cut), (cut, items.item_req.shape[0]))]
    t1, l1, s1 = pack_scan(t, part[0], compat[:cut], key[:cut], n_slots=t.n_slots)
    t2, l2, s2 = pack_scan(t, part[1], compat[cut:], key[cut:], n_slots=t.n_slots, init_state=s1)
    assert torch.equal(torch.cat([t1, t2]), takes) and torch.equal(torch.cat([l1, l2]), left)
    for a, b in zip(list(s2[:7]) + list(s2[7]), list(state[:7]) + list(state[7])):
        assert torch.equal(a, b)
    nnz = int(ref["ref_nnz_cap"])
    flat = flat_outputs(takes, left, state[0], state[2], state[6], nnz)
    assert torch.equal(flat, flat_outputs_plain(takes, left, state[0], state[2], state[6], nnz))
    np.testing.assert_array_equal(flat.cpu().numpy(), ref["ref_flat"])


@pytest.mark.gpu
def test_gpusolver_on_card_matches_reference(cuda_device):
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    problem, ref = load_npz(FIXTURE_DIR / "small_spread_anti_ports.npz")
    build.reset_launches()
    res = GPUSolver().solve_encoded(problem)
    assert build.LAUNCHES == {"feasibility": 1, "pack_scan": 1, "pack_scan_sharded": 0, "pack_scan_cluster": 0,
                              "sparsify": 1, "recredit": 0, "globalpack": 0, "score_subsets": 0, "anneal_pack": 0,
                              "anneal": 0, "perpod_pack": 0}
    assert res.errors == []
    np.testing.assert_array_equal(res.assignment, ref["ref_assignment"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["chain_small_members", "chain_small_bind_flush", "churn_headline_5000x100"])
def test_recredit_kernel_equals_plain_on_card(cuda_device, name):
    """K4 against recredit_plain on the card, both against the recorded JAX
    carry, for every recredit of the chain."""
    import types

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.recredit import recredit, recredit_plain
    from karpenter_tpu_torch.models.scheduler_model_grouped import REMOVAL_BUCKET
    from karpenter_tpu_torch.solver.encoded import load_chain
    from test_torch_fixtures import CHAIN_DIR, STATE_LEAVES

    problems, ref = load_chain(CHAIN_DIR / f"{name}.npz")
    checked = 0
    for i, p in enumerate(problems):
        pre = f"s{i}."
        if pre + "rc_slot_idx" not in ref:
            continue
        G_p = ref[pre + "rc_zmem"].shape[1]
        gdk = np.full(G_p, -1, np.int32)
        gdk[: p.n_groups] = p.group_dom_key
        t = types.SimpleNamespace(group_dom_key=torch.as_tensor(gdk, device=cuda_device),
                                  dom_key_of=torch.as_tensor(p.dom_key_of, device=cuda_device))
        K = ref[pre + "rc_slot_idx"].shape[0]
        pad = -K % REMOVAL_BUCKET
        args = [np.concatenate([ref[pre + "rc_slot_idx"], np.full(pad, -1, np.int32)]),
                np.concatenate([ref[pre + "rc_req"], np.zeros((pad, ref[pre + "rc_req"].shape[1]), np.float32)]),
                np.concatenate([ref[pre + "rc_zmem"], np.zeros((pad, G_p), bool)]),
                np.concatenate([ref[pre + "rc_hmem"], np.zeros((pad, G_p), bool)])]
        args = [torch.as_tensor(a, device=cuda_device) for a in args]
        leaves = [torch.as_tensor(ref[f"{pre}rc_in_{k}"], device=cuda_device) for k in STATE_LEAVES]
        state = tuple(leaves[:7]) + (tuple(leaves[7:]),)
        build.reset_launches()
        got = recredit(state, t, *args)
        plain = recredit_plain(state, t, *args)
        torch.cuda.synchronize()
        assert build.LAUNCHES["recredit"] == 1
        for leaf, a, b in zip(STATE_LEAVES, list(got[:7]) + list(got[7]), list(plain[:7]) + list(plain[7])):
            want = torch.as_tensor(ref[f"{pre}rc_out_{leaf}"])
            assert torch.equal(a, b), leaf
            assert torch.equal(a.cpu(), want.reshape(a.shape)), leaf
        checked += 1
    assert checked


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_slot_many", "padding_neg_zero", "wide", "k_12000"])
def test_recredit_kernel_synthetic_on_card(cuda_device, case):
    """K4 against recredit_plain, bit for bit, on the synthetic recredits of
    `chip_smoke.recredit_cases`: many removals folded into one slot, padding
    over a -0.0 in slot 0 (it comes back +0.0), K = 1500 and K = 12000
    removals."""
    import chip_smoke
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.recredit import recredit, recredit_plain

    _name, *args = next(c for c in chip_smoke.recredit_cases(cuda_device) if c[0] == case)
    build.reset_launches()
    got = recredit(*args)
    plain = recredit_plain(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["recredit"] == 1
    assert chip_smoke.same_carry(got, plain)
    if case == "padding_neg_zero":
        assert bool((got[1][0].view(torch.int32) == 0).all())


@pytest.mark.gpu
def test_pack_scan_on_fleet_past_the_tile(cuda_device):
    """K2 on `existing_fleet_1200`: 1200 open slots from the first item, past
    one 1024-slot chunk and the kernel's shared-memory tile; equal to the
    plain pack and to the stored JAX outputs, one pass and continued from a
    carry."""
    from dataclasses import fields

    from karpenter_tpu_torch.kernels.feasibility import feasibility
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan, pack_scan_plain
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs
    from karpenter_tpu_torch.models import scheduler_model_grouped as tsg
    from test_torch_fixtures import STATE_LEAVES

    problem, ref = load_npz(FIXTURE_DIR / "existing_fleet_1200.npz")
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, cuda_device)
    t = tsm.make_tensors(problem, cuda_device, n_slots=int(ref["ref_n_slots"]))
    assert t.n_existing > 1024
    compat, key = feasibility(t, items)
    takes, left, state = pack_scan(t, items, compat, key, n_slots=t.n_slots)
    takes_p, left_p, state_p = pack_scan_plain(t, items, n_slots=t.n_slots, precomputed=(compat, key))
    assert torch.equal(takes, takes_p) and torch.equal(left, left_p)
    leaves = list(state[:7]) + list(state[7])
    for leaf, a, b in zip(STATE_LEAVES, leaves, list(state_p[:7]) + list(state_p[7])):
        assert torch.equal(a, b), leaf
        assert torch.equal(a.cpu(), torch.as_tensor(ref[f"ref_state_{leaf}"]).reshape(a.shape)), leaf
    assert bool(takes[:, 1024:].any())
    flat = flat_outputs(takes, left, state[0], state[2], state[6], int(ref["ref_nnz_cap"]))
    np.testing.assert_array_equal(flat.cpu().numpy(), ref["ref_flat"])
    cut = items.item_req.shape[0] // 2
    part = [tsg.ItemTensors(**{f.name: getattr(items, f.name)[lo:hi] for f in fields(tsg.ItemTensors)})
            for lo, hi in ((0, cut), (cut, items.item_req.shape[0]))]
    t1, l1, s1 = pack_scan(t, part[0], compat[:cut], key[:cut], n_slots=t.n_slots)
    t2, l2, s2 = pack_scan(t, part[1], compat[cut:], key[cut:], n_slots=t.n_slots, init_state=s1)
    assert torch.equal(torch.cat([t1, t2]), takes) and torch.equal(torch.cat([l1, l2]), left)
    for a, b in zip(list(s2[:7]) + list(s2[7]), leaves):
        assert torch.equal(a, b)


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    """On CPU tensors every wrapper runs its plain version; an unsupported
    device raises instead of falling back."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs

    build.reset_launches()
    takes = torch.tensor([[0, 2], [1, 0]], dtype=torch.int32)
    left = torch.zeros(2, dtype=torch.int32)
    basis = torch.tensor([3, -1], dtype=torch.int32)
    zs = torch.tensor([[True], [False]])
    flat = flat_outputs(takes, left, basis, zs, torch.tensor(1, dtype=torch.int32), 4)
    assert flat.tolist() == [0, 1, -1, -1, 1, 0, -1, -1, 2, 1, 0, 0, 3, -1, 1, 0, 0, 0, 1]
    assert all(v == 0 for v in build.LAUNCHES.values())
    with pytest.raises(ValueError):
        flat_outputs(takes.to("meta"), left, basis, zs, torch.tensor(1, dtype=torch.int32), 4)


CONSOLIDATION = ("small_lp_6", "small_global_6_pending", "small_anneal_7", "lp_5000", "global_5000_hetero_pending",
                 "anneal_256")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CONSOLIDATION)
def test_consolidation_kernels_equal_plain_on_card(cuda_device, name):
    """K5, K6 and K7 against their plain versions on the card, and against
    the stored JAX outputs (tolerances of the CPU tests: K6 and K7 exact,
    K5's d within 2e-6 of the reference)."""
    from karpenter_tpu_torch.kernels.anneal import anneal, anneal_plain
    from karpenter_tpu_torch.kernels.globalpack import globalpack, globalpack_plain
    from karpenter_tpu_torch.kernels.score_subsets import score_subsets, score_subsets_plain
    from karpenter_tpu_torch.solver.consolidation import reference_inits, tensors_from_problem
    from test_torch_consolidation import load

    problem, ref = load(name)
    if str(ref["kind"]) == "anneal":
        t, _aux = tensors_from_problem(problem, cuda_device, dense_compat=True)
        streams = [torch.as_tensor(ref[k], device=cuda_device) for k in ("ref_x0", "ref_flips", "ref_u")]
        got, want = anneal(t, *streams), anneal_plain(t, *streams)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        np.testing.assert_array_equal(got[0].cpu().numpy(), ref["ref_best_x"])
        np.testing.assert_array_equal(got[1].cpu().numpy(), ref["ref_best_s"])
        return
    t, aux = tensors_from_problem(problem, cuda_device)
    d0, y0 = (torch.as_tensor(a, device=cuda_device) for a in reference_inits(problem, ref))
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0)
    for n_iters, key in ((1, "ref_d_it1"), (5, "ref_d_it5"), (300, "ref_d")):
        d, s = globalpack(*args, n_iters)
        d_p, s_p = globalpack_plain(*args, n_iters)
        torch.cuda.synchronize()
        assert float((d - d_p).abs().max()) <= 2e-6, n_iters
        np.testing.assert_allclose(d.cpu().numpy(), ref[key], rtol=0, atol=2e-6)
    X = torch.as_tensor(ref["ref_X"], device=cuda_device)
    pend = (aux["pend_req"], aux["pend_npods"], aux["pend_active"])
    s, f = score_subsets(t, aux["onehot"], aux["compat_nq"], *pend, X)
    s_p, f_p = score_subsets_plain(t, aux["onehot"], aux["compat_nq"], *pend, X)
    torch.cuda.synchronize()
    assert torch.equal(s, s_p) and torch.equal(f, f_p)
    np.testing.assert_array_equal(s.cpu().numpy(), ref["ref_scores"])
    np.testing.assert_array_equal(f.cpu().numpy(), ref["ref_feas"])


@pytest.mark.gpu
def test_lp_proposer_launches_k5_and_k6_once(cuda_device):
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.solver.consolidation import propose_problem_lp, reference_inits, reference_proposals
    from test_torch_consolidation import load

    problem, ref = load("lp_5000")
    build.reset_launches()
    out = propose_problem_lp(problem, inits=reference_inits(problem, ref))
    assert build.LAUNCHES["globalpack"] == 1 and build.LAUNCHES["score_subsets"] == 1
    assert out == reference_proposals(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SMALL + ("small_min_domains_hostname", "headline_aff_5000x100"))
def test_perpod_kernels_equal_plain_on_card(cuda_device, name):
    """K1 over the pods and K8 against their plain versions on the card (the
    five outputs and the whole carry), the outputs against the stored JAX
    per-pod pack, and one launch of each per `greedy_pack` call."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, compat_and_key_plain
    from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack, perpod_pack_plain

    problem, _ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    with np.load(FIXTURE_DIR / "perpod" / f"{name}.npz") as z:
        ref = {k: z[k] for k in z.files}
    t = tsm.make_tensors(problem, cuda_device)
    pods = tsm.make_pod_tensors(problem, cuda_device, t)
    args = (t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    compat, key = compat_and_key(*args)
    compat_p, key_p = compat_and_key_plain(*args)
    assert torch.equal(compat, compat_p) and torch.equal(key, key_p)
    got = perpod_pack(t, pods, compat, key)
    plain = perpod_pack_plain(t, pods, compat_p, key_p)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    for k, a in zip(("assignment", "slot_basis", "slot_domset", "slot_rank", "open_count"), got):
        np.testing.assert_array_equal(a.cpu().numpy(), ref[f"ref_{k}"], err_msg=k)
    build.reset_launches()
    tsm.greedy_pack(t, pods)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {"feasibility": 1, "perpod_pack": 1}


@pytest.mark.gpu
def test_caps_kernels_equal_plain_on_card(cuda_device):
    """K1, K2 (full and from its carry), K8, K5, K6 and K7 on the problems
    past the kernels' former axis limits (`chip_smoke.check_caps`)."""
    import chip_smoke

    shapes = chip_smoke.check_caps(cuda_device, {"globalpack": 0.0})
    assert shapes["caps_groups"]["G"] > 256 and shapes["caps_wide"]["R"] > 16 and shapes["large"]["Np"] >= 32768


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["below", "cross", "at_reach", "above"])
def test_perpod_kernel_across_the_warp_reach_on_card(cuda_device, case):
    """K8 against its plain version (the five outputs and the whole carry)
    on the synthetic problems whose open-slot counts stay below, cross and
    start past the warp path's reach (`chip_smoke.PERPOD_REGIME_CASES`)."""
    import chip_smoke
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key
    from karpenter_tpu_torch.kernels.perpod_pack import perpod_pack, perpod_pack_plain

    s = chip_smoke.perpod_regime_arrays(*chip_smoke.PERPOD_REGIME_CASES[case])
    t, pods = chip_smoke.perpod_tensors(s, cuda_device)
    compat, key = compat_and_key(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    got = perpod_pack(t, pods, compat, key)
    want = perpod_pack_plain(t, pods, compat, key)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("Np", [256, 8192, 32768])
@pytest.mark.parametrize("pending", [False, True])
def test_score_subsets_clusters_on_card(cuda_device, Np, pending):
    """K6 (a cluster of 1 or 8 blocks per row) against its plain version,
    bit for bit, at Np = 256, 8192 and 32768 (`chip_smoke.K6_SIZES`)."""
    import chip_smoke

    assert chip_smoke.check_score_subsets_size(Np, pending, cuda_device) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 1001), (640, 4096), (3, 30000), (0, 64), (1, 5)])
def test_sparsify_one_launch_equals_plain_on_card(cuda_device, shape):
    """K3 (one launch, decoupled look-back) against `flat_outputs_plain` on
    random take matrices: a ragged slot axis, the headline's, rows longer
    than the shared-memory copy, no rows, one row; with room for every
    triple and with nnz_cap below the count (entries past it dropped);
    several calls in a row on one scratch."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.sparsify import flat_outputs, flat_outputs_plain

    W, N = shape
    g = torch.Generator(device=cuda_device).manual_seed(W * 7 + N)
    takes = (torch.rand((W, N), generator=g, device=cuda_device) < 0.01).int() * torch.randint(
        1, 5, (W, N), generator=g, device=cuda_device, dtype=torch.int32)
    args = (takes, torch.randint(0, 9, (W,), generator=g, device=cuda_device, dtype=torch.int32),
            torch.randint(-1, 9, (N,), generator=g, device=cuda_device, dtype=torch.int32),
            torch.rand((N, 3), generator=g, device=cuda_device) < 0.5,
            torch.tensor(5, dtype=torch.int32, device=cuda_device))
    nnz = int((takes != 0).sum())
    for cap in (nnz + 64, max(1, nnz // 2), 1):
        for _ in range(3):
            build.reset_launches()
            got = flat_outputs(*args, cap)
            assert build.LAUNCHES["sparsify"] == 1
            assert torch.equal(got, flat_outputs_plain(*args, cap)), cap


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["small_anneal_4", "anneal_256", "caps_anneal", "ragged"])
def test_anneal_prepass_equals_plain_on_card(cuda_device, name):
    """K7's pre-pass (bit rows by host and by deleted node, the undominated
    rows, the flag) against its plain version, bit for bit."""
    import dataclasses

    from karpenter_tpu_torch.kernels.anneal import anneal_prepass, anneal_prepass_plain
    from karpenter_tpu_torch.solver.consolidation import load_npz as cons_load
    from karpenter_tpu_torch.solver.consolidation import tensors_from_problem
    from test_torch_consolidation import load

    if name == "caps_anneal":
        problem, ref = cons_load(FIXTURE_DIR / "caps" / "caps_anneal.npz")
    else:
        problem, ref = load("small_anneal_7" if name == "ragged" else name)
    t, _aux = tensors_from_problem(problem, cuda_device, dense_compat=True)
    flips = torch.as_tensor(ref["ref_flips"], device=cuda_device)
    if name == "ragged":  # a side that is not a multiple of 32
        g = torch.Generator(device=cuda_device).manual_seed(1)
        t = dataclasses.replace(t, pod_compat=(torch.rand((45, 45), generator=g, device=cuda_device) < 0.5).float())
        flips = flips % 45
    got = anneal_prepass(t, flips)
    want = anneal_prepass_plain(t, flips)
    assert int(got[3].item()) == 0
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_anneal_kernel_shapes_and_flags_on_card(cuda_device):
    """K7 against `anneal_plain` at one warp (Np = 16), with R = 5 (the build
    that reads R at run time), with no steps, and one pre-pass and one chain
    launch per call; a non-0/1 pod_compat or a flip out of range raises."""
    import dataclasses

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.anneal import anneal, anneal_plain
    from karpenter_tpu_torch.solver.consolidation import tensors_from_problem
    from test_torch_consolidation import load

    problem, ref = load("small_anneal_4")
    t, _aux = tensors_from_problem(problem, cuda_device, dense_compat=True)
    streams = [torch.as_tensor(ref[k], device=cuda_device) for k in ("ref_x0", "ref_flips", "ref_u")]
    t5 = dataclasses.replace(t, node_slack=torch.cat([t.node_slack, t.node_slack[:, :1] * 0.5], 1).contiguous(),
                             node_used=torch.cat([t.node_used, t.node_used[:, :1] * 0.5], 1).contiguous(),
                             row_alloc=torch.cat([t.row_alloc, t.row_alloc[:, :1] * 0.5], 1).contiguous())
    for tt, ss in ((t, streams), (t5, streams), (t, [streams[0], streams[1][:, :0], streams[2][:, :0]])):
        build.reset_launches()
        got = anneal(tt, *[x.contiguous() for x in ss])
        assert build.LAUNCHES["anneal_pack"] == 1 and build.LAUNCHES["anneal"] == 1
        want = anneal_plain(tt, *ss)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    bad = t.pod_compat.clone()
    bad[2, 3] = 0.5
    with pytest.raises(ValueError, match="only 0 and 1"):
        anneal(dataclasses.replace(t, pod_compat=bad), *streams)
    flips = streams[1].clone()
    flips[1, 2] = -1
    with pytest.raises(ValueError, match="flips outside"):
        anneal(t, streams[0], flips, streams[2])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["edges", "wide", "none", "b70000", "rows_1000", "spill"])
def test_feasibility_cases_equal_plain_on_card(cuda_device, case):
    """K1 against `compat_and_key_plain` on `chip_smoke.K1_CASES`, bit for
    bit: negative label ids and ids past the last word, forced keys of -1,
    0, K - 1 and K, out-of-range taint classes, zero requests and pad rows,
    K = 40 with Words = 2, no items, 70000 items (past the old grid's y
    axis), a row axis that is not a multiple of 32, and a K whose rows go to
    the global scratch."""
    import chip_smoke

    errs = {"feasibility": 0.0}
    chip_smoke.check_k1_case(case, cuda_device, errs)
    assert errs["feasibility"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_feasibility_random_edges_equal_plain_on_card(cuda_device, seed):
    """K1 against its plain version on `test_torch_feasibility._random_case`
    (the inputs its CPU test holds to the reference), one launch each."""
    import types

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, compat_and_key_plain
    from karpenter_tpu_torch.ops.bitset import as_int32_words
    from test_torch_feasibility import _random_case

    masks, labels, taint_class, taints_ok, req, alloc, rank, dom_keys = _random_case(seed)

    def f(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=cuda_device, dtype=dtype)

    t = types.SimpleNamespace(row_labels=f(labels, torch.int32), row_taint_class=f(taint_class, torch.int32),
                              row_alloc=f(alloc, torch.float32), row_pool_rank=f(rank, torch.int32), dom_keys=dom_keys,
                              forced_keys=tsm.forced_key_mask(dom_keys, labels.shape[1], cuda_device))
    args = (t, f(as_int32_words(masks), torch.int32), f(taints_ok, torch.bool), f(req, torch.float32))
    build.reset_launches()
    compat, key = compat_and_key(*args)
    assert build.LAUNCHES["feasibility"] == 1
    compat_p, key_p = compat_and_key_plain(*args)
    assert torch.equal(compat, compat_p) and torch.equal(key.view(torch.int32), key_p.view(torch.int32))


# (form, shard count) of the slot-sharded K2 held to K2 and the plain arm:
# the cluster form up to the card's largest placeable cluster ("largest",
# asked of the card in the test), the grid form past it (33 and 64 are past
# one warp's lanes: the exchange reduces in strides of 32)
SHARDED_CASES = (("cluster", 2), ("cluster", 3), ("cluster", 4), ("cluster", 5), ("cluster", 8),
                 ("cluster", "largest"), ("grid", "largest + 1"), ("grid", 33), ("grid", 64))


@pytest.mark.gpu
@pytest.mark.parametrize("name", SMALL)
@pytest.mark.parametrize("form, n_shards", SHARDED_CASES)
def test_sharded_pack_scan_equals_k2_and_plain_on_card(cuda_device, name, form, n_shards):
    """Each form of the slot-sharded K2 against K2 (gathered carry) and
    against the plain multi-shard arm (every shard's carry), bit for bit, on
    a slot axis padded to the shard count; the chooser picks the form for
    the shape, and both forms and the plain arm count the same exchanges."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import feasibility
    from karpenter_tpu_torch.kernels import pack_scan as kps
    from karpenter_tpu_torch.models import scheduler_model_grouped as tsg
    from karpenter_tpu_torch.models.shard_exchange import pack_scan_sharded_plain
    from karpenter_tpu_torch.parallel import sharded as sh

    problem, ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, cuda_device)
    t0 = tsm.make_tensors(problem, cuda_device, n_slots=int(ref["ref_n_slots"]))

    def padded(S):
        return sh.pad_slots_for_mesh(t0, sh.make_mesh([cuda_device] * S))

    if isinstance(n_shards, str):
        # the largest cluster that places at the shape of a 16-shard split
        largest = kps.largest_cluster(t0, items, n_slots=padded(16).n_slots, n_shards=16)
        largest = largest if largest == 16 else kps.largest_cluster(t0, items, n_slots=padded(largest).n_slots,
                                                                   n_shards=largest)
        assert largest >= 8, f"the card places clusters of only {largest} shard blocks"
        n_shards = largest if n_shards == "largest" else largest + 1
    t = padded(n_shards)
    compat, key = feasibility(t, items)
    build.reset_launches()
    takes, left, shards, barrier, chosen = kps.pack_scan_sharded(t, items, compat, key, n_slots=t.n_slots,
                                                                 n_shards=n_shards)
    assert chosen == form and build.LAUNCHES[kps.FORMS[form]] == 1
    other = "grid" if form == "cluster" else "cluster"
    assert build.LAUNCHES[kps.FORMS[other]] == 0
    takes_p, left_p, shards_p, barrier_p = pack_scan_sharded_plain(t, items, compat, key, n_slots=t.n_slots,
                                                                   n_shards=n_shards)
    takes_1, left_1, one = kps.pack_scan(t, items, compat, key, n_slots=t.n_slots)
    assert torch.equal(takes, takes_p) and torch.equal(left, left_p)
    assert torch.equal(takes, takes_1) and torch.equal(left, left_1)
    for s, s_p in zip(shards, shards_p):
        for a, b in zip(list(s[:7]) + list(s[7]), list(s_p[:7]) + list(s_p[7])):
            assert torch.equal(a, b)
    # the plain arm exchanges at every take total, the kernels only where
    # K2's closed form fails: the kernels' two forms count the same
    assert int(barrier) % n_shards == 0 and 0 < int(barrier) <= int(barrier_p)
    if form == "cluster":
        grid = kps.pack_scan_sharded_grid(t, items, compat, key, n_slots=t.n_slots, n_shards=n_shards)
        assert int(grid[3]) == int(barrier)
        assert torch.equal(grid[0], takes) and torch.equal(grid[1], left)
    whole = sh.ShardedState(sh.make_mesh([cuda_device] * n_shards), shards, barrier, chosen).gather_state()
    for a, b in zip(list(whole[:7]) + list(whole[7]), list(one[:7]) + list(one[7])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_meshed_solver_on_card_matches_unmeshed(cuda_device):
    """A full solve on a mesh of four shards of the card: K1 once per shard
    and the slot-sharded K2 once, in its cluster form."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.parallel.sharded import ShardedState, make_mesh
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    problem, ref = load_npz(FIXTURE_DIR / "small_spread_anti_ports.npz")
    build.reset_launches()
    solver = GPUSolver(mesh=make_mesh([cuda_device] * 4))
    res = solver.solve_encoded(problem)
    assert build.LAUNCHES["pack_scan_cluster"] == 1 and build.LAUNCHES["feasibility"] == 4
    assert build.LAUNCHES["pack_scan"] == 0 and build.LAUNCHES["pack_scan_sharded"] == 0
    state = solver._resident["state"]
    assert isinstance(state, ShardedState) and state.exchange == "cluster"
    assert res.errors == []
    np.testing.assert_array_equal(res.assignment, ref["ref_assignment"])


@pytest.mark.gpu
def test_wide_mesh_solve_on_card_matches_reference(cuda_device):
    """`GPUSolver(mesh=make_mesh([cuda] * 33))` on the seeded headline: the
    reference's Results, K1 once per shard and the slot-sharded K2 once, in
    its grid form (`chip_smoke.check_mesh_steps`)."""
    import chip_smoke

    snap, _added, _one = chip_smoke.seeded_snapshot()
    paths = chip_smoke.check_mesh_steps(cuda_device, "solve", chip_smoke.SOLVE_FIXTURE, chip_smoke.SOLVE_STEPS[:1],
                                        chip_smoke.SOLVE_LAUNCHES[:1], ("step 0",), lambda i, _p, _s: snap,
                                        force=True, shards=33, form="grid")
    assert paths[0]["pack_scan_sharded"] == 1 and paths[0]["feasibility"] == 33
    assert "pack_scan_cluster" not in paths[0]


@pytest.mark.gpu
def test_dra_steps_on_card_match_reference(cuda_device):
    """The DRA headline's steps on the card (`chip_smoke.check_dra`): the
    reference's Results, modes, reasons and allocations, K1-K3 once each per
    step, each pack equal to its plain version on its kept inputs."""
    import chip_smoke

    errs = {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0, "recredit": 0.0}
    out = chip_smoke.check_dra(cuda_device, torch.cuda.get_device_name(0), errs, runs=1)
    assert out["paths"] == [{"feasibility": 1, "pack_scan": 1, "sparsify": 1}] * 3
    assert errs == {"feasibility": 0.0, "pack_scan": 0.0, "sparsify": 0.0, "recredit": 0.0}


@pytest.mark.gpu
def test_sharded_pack_scan_refuses_what_it_cannot_split(cuda_device):
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.pack_scan import pack_scan_sharded
    from types import SimpleNamespace as NS

    x = torch.zeros((2, 2), dtype=torch.float32, device=cuda_device)
    for n_slots, n_shards in ((10, 3), (64, 33)):
        with pytest.raises(build.KernelArgError, match="do not split"):
            pack_scan_sharded(None, NS(item_req=x), None, None, n_slots=n_slots, n_shards=n_shards)


@pytest.mark.gpu
def test_operator_scenario_on_card(cuda_device):
    """The seeded operator scenario (`torch_operator_scenario`: provisioning,
    then consolidation after half the pods leave), the port's arm on the
    card against the same arm on the CPU: every tick's canonical state,
    solves and disruption commands equal, and the solver on the card."""
    from torch_operator_scenario import port_watch, run_phases

    cpu = run_phases(port_watch(device="cpu"))
    watch = port_watch(device=None)
    assert watch.env.provisioner.solver.device.type == "cuda"
    card = run_phases(watch)
    assert len(card) == len(cpu) == 2
    for g, w in zip(card, cpu):
        assert g["records"] == w["records"] and g["state"] == w["state"]


@pytest.mark.gpu
def test_serving_churn_on_card_matches_cpu(cuda_device):
    """The small seeded churn of `test_torch_serving.py` (`SMALL`), the
    port's harness on the card against the same harness on the CPU: every
    solve's mode, the digest after every bind flush, the report's
    wall-clock-free fields and the repack after a revocation equal, the
    solver on the card."""
    import tempfile

    from karpenter_tpu_torch.testing import serving as sv
    from test_torch_serving import SMALL

    runs = []
    for dev in ("cpu", None):
        sv.fresh_state()
        api = sv.port_api(dev)
        h = api.harness(api.ChurnSpec(**SMALL, record_path=tempfile.mktemp(suffix=".jsonl")))
        try:
            out = sv.run_recorded(api, h)
            out.pop("_report")
            out["repack"] = sv.revoke_and_repack(api, h)
            out["device"] = h.env.provisioner.solver.device.type
        finally:
            h.close()
        runs.append(out)
    cpu, card = runs
    assert (cpu["device"], card["device"]) == ("cpu", "cuda")
    for key in ("modes", "digests", "report", "repack"):
        assert card[key] == cpu[key], key
