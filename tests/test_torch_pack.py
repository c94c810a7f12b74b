"""The PyTorch port's pack against the JAX reference, on the CPU.

- `make_tensors` / `build_items` equal the reference array by array;
- the plain pack scan (`_pack_body`) plus the plain sparsify give a flat
  output and a final carry identical (`torch.equal`) to the stored
  `_pack_compressed_impl` output, on every fixture (the headline problems
  included);
- `GPUSolver(device="cpu").solve_encoded` equals the JAX path
  (build_items -> make_tensors -> greedy_pack_grouped_compressed ->
  assignment_from_triples -> fast_validate) on fresh encodes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu.models import scheduler_model as jsm
from karpenter_tpu.models import scheduler_model_grouped as jsg
from karpenter_tpu.solver.check import fast_validate as ref_fast_validate
from karpenter_tpu.solver.encode import encode
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.models import scheduler_model_grouped as tsg
from karpenter_tpu_torch.solver.encoded import from_reference, load_npz
from karpenter_tpu_torch.solver.gpu import GPUSolver
from test_torch_fixtures import CORPUS, FIXTURE_DIR, STATE_LEAVES, corpus_snapshot

# the plain scan is thousands of tiny ops: one intra-op thread per test worker
torch.set_num_threads(1)

SMALL = sorted(n for n in CORPUS if n.startswith("small_"))
ALL = sorted(CORPUS)


@pytest.fixture(autouse=True)
def _fresh_highwater():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()


def _encode(name):
    enc = encode(corpus_snapshot(name))
    return enc, from_reference(enc)


@pytest.mark.parametrize("name", SMALL)
def test_tensors_and_items_match_reference(name):
    enc, p = _encode(name)
    ref_arrays, ref_pods, ref_info = jsg.build_items(enc, with_info=True)
    arrays, pods, info = tsg.build_items(p, with_info=True)
    assert info == ref_info
    assert set(arrays) == set(ref_arrays)
    for k in ref_arrays:
        assert arrays[k].dtype == ref_arrays[k].dtype, k
        np.testing.assert_array_equal(arrays[k], ref_arrays[k], err_msg=k)
    assert len(pods) == len(ref_pods)
    for a, b in zip(pods, ref_pods):
        np.testing.assert_array_equal(a, b)
    items = tsg.make_item_tensors(arrays, "cpu")
    np.testing.assert_array_equal(items.item_mask.numpy().view(np.uint32), arrays["item_mask"])

    cap = enc.n_existing + min(enc.n_pods, 4096)
    rt = jsm.make_tensors(enc, n_slots=cap, with_pods=False)
    tt = tsm.make_tensors(p, "cpu", n_slots=cap)
    assert tt.n_slots == rt.n_slots and tt.n_existing == rt.n_existing and tt.dom_keys == rt.dom_keys
    assert tt.n_rows_real == int(rt.n_rows_real)
    for f in ("row_alloc", "row_labels", "row_pool_rank", "row_taint_class", "rank_domset", "rank_dom_cap",
              "dom_key_of", "group_kind", "group_skew", "group_dom_key", "group_min_domains", "group_registered",
              "counts_dom_init", "counts_host_init", "existing_domset", "existing_port_any", "existing_port_wild",
              "existing_port_spec", "row_port_any", "row_port_wild", "row_port_spec"):
        a, b = getattr(tt, f).numpy(), np.asarray(getattr(rt, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", ALL)
def test_plain_pack_equals_reference_pack(name):
    """Flat output and every carry leaf of the plain scan are identical to
    the JAX `_pack_compressed_impl` output stored in the fixture."""
    problem, ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, "cpu")
    n_slots = int(ref["ref_n_slots"])
    t = tsm.make_tensors(problem, "cpu", n_slots=n_slots)
    assert t.n_slots == n_slots
    nnz_cap = int(ref["ref_nnz_cap"])
    takes, left, state = tsg._pack_body(t, items, n_slots=n_slots)
    flat = tsg._flat_outputs(takes, left, state[0], state[2], state[6], nnz_cap)
    assert torch.equal(flat, torch.as_tensor(ref["ref_flat"]))
    leaves = list(state[:7]) + list(state[7])
    for leaf, got in zip(STATE_LEAVES, leaves):
        want = torch.as_tensor(ref[f"ref_state_{leaf}"])
        assert got.dtype == want.dtype, leaf
        assert torch.equal(got, want), leaf


@pytest.mark.parametrize("name", SMALL)
def test_gpusolver_cpu_equals_reference_path(name):
    enc, p = _encode(name)
    ref_arrays, ref_pods = jsg.build_items(enc)
    items = jsg.make_item_tensors(ref_arrays)
    t = jsm.make_tensors(enc, n_slots=enc.n_existing + min(enc.n_pods, 4096), with_pods=False)
    out = jsg.greedy_pack_grouped_compressed(t, items, enc.n_pods)
    assignment = jsg.assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], ref_pods, enc.n_pods)
    ref_errors = ref_fast_validate(enc, assignment, out["slot_basis"], out["slot_zoneset"])

    tsm.reset_bucket_highwater()
    res = GPUSolver(device="cpu").solve_encoded(p)
    np.testing.assert_array_equal(res.assignment, assignment)
    np.testing.assert_array_equal(res.slot_basis, out["slot_basis"])
    np.testing.assert_array_equal(res.slot_zoneset, out["slot_zoneset"])
    np.testing.assert_array_equal(res.leftovers, out["leftovers"])
    assert res.open_count == out["open_count"]
    assert res.errors == ref_errors == []
    assert res.n_placed == int((assignment >= 0).sum())
    assert res.relaxation_required is False
    ref_state = list(out["state"][:7]) + list(out["state"][7])
    for leaf, got, want in zip(STATE_LEAVES, list(res.state[:7]) + list(res.state[7]), ref_state):
        assert torch.equal(got, torch.as_tensor(np.array(want))), leaf


def test_slot_overflow_retries_uncapped(monkeypatch):
    """A capped slot axis that fills up with pods left over is retried with
    the uncapped axis, as the reference solver does: 600 hostname
    anti-affinity replicas need 600 slots, the capped axis holds 512."""
    import karpenter_tpu_torch.solver.gpu as gpu
    from helpers import hostname_anti_affinity, make_pod
    from test_domain_topology import make_snapshot

    sel = {"matchLabels": {"app": "solo"}}
    pods = [make_pod(cpu="100m", labels={"app": "solo"}, anti_affinity=[hostname_anti_affinity(sel)]) for _ in range(600)]
    enc = encode(make_snapshot(pods))
    p = from_reference(enc)
    monkeypatch.setattr(gpu, "SLOT_CAP", 1)
    calls = []
    real = gpu.make_tensors

    def spy(problem, device, n_slots=None):
        calls.append(n_slots)
        return real(problem, device, n_slots=n_slots)

    monkeypatch.setattr(gpu, "make_tensors", spy)
    res = GPUSolver(device="cpu").solve_encoded(p)
    assert calls == [enc.n_existing + 1, None]
    assert res.errors == [] and res.n_placed == 600 and res.n_slots == 1024

    ref_arrays, ref_pods = jsg.build_items(enc)
    t = jsm.make_tensors(enc, with_pods=False)
    out = jsg.greedy_pack_grouped_compressed(t, jsg.make_item_tensors(ref_arrays), enc.n_pods)
    assignment = jsg.assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], ref_pods, enc.n_pods)
    np.testing.assert_array_equal(res.assignment, assignment)
    assert res.open_count == out["open_count"]


@pytest.mark.parametrize("name", ["small_existing_affinity", "small_multigroup"])
def test_scan_continues_from_a_carry(name):
    """Packing the first items, then the rest from the returned carry, gives
    the same takes and final carry as one pass (the delta path's contract)."""
    from dataclasses import fields

    problem, ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, "cpu")
    t = tsm.make_tensors(problem, "cpu", n_slots=int(ref["ref_n_slots"]))
    takes, left, state = tsg._pack_body(t, items, n_slots=t.n_slots)
    cut = int((arrays["item_count"] > 0).sum()) // 2

    def part(lo, hi):
        return tsg.ItemTensors(**{f.name: getattr(items, f.name)[lo:hi] for f in fields(tsg.ItemTensors)})

    t1, l1, s1 = tsg._pack_body(t, part(0, cut), n_slots=t.n_slots)
    t2, l2, s2 = tsg._pack_body(t, part(cut, items.item_req.shape[0]), n_slots=t.n_slots, init_state=s1)
    assert torch.equal(torch.cat([t1, t2]), takes) and torch.equal(torch.cat([l1, l2]), left)
    for a, b in zip(list(s2[:7]) + list(s2[7]), list(state[:7]) + list(state[7])):
        assert torch.equal(a, b)
