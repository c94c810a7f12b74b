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
    assert build.LAUNCHES == {"feasibility": 1, "pack_scan": 1, "sparsify": 1, "recredit": 0}
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
