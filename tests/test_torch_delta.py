"""The PyTorch port's delta solve against the JAX reference, on the CPU.

- every small chain fixture (`karpenter_tpu_torch/fixtures/chains/`, made by
  the JAX `TPUSolver` and rebuilt by `tests/test_torch_fixtures.py`), driven
  through `GPUSolver(device="cpu").solve_encoded`, equals the reference step
  by step: the mode, the delta-reject reason, the assignment, the basis,
  the zoneset and every leaf of the resident carry;
- the delta pack (`greedy_pack_delta_compressed`) on each recorded input
  carry gives the reference's flat output and final carry;
- `apply_row_diff`, `recount_anti_groups` and `rebuild_port_planes` equal
  the reference's static methods on the same inputs.

Tolerance: exact (`torch.equal`, `assert_array_equal`) everywhere: every
value is an integer, a bool or an f32 computed by the same operations in
the same order. The headline chain's plain pack is too slow for tier-1: it
runs in `chip_smoke.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.models import scheduler_model as jsm
from karpenter_tpu.solver.encode import encode
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.models import scheduler_model_grouped as tsg
from karpenter_tpu_torch.solver import carry
from karpenter_tpu_torch.solver.encoded import RowDiff, from_reference, load_chain
from karpenter_tpu_torch.solver.gpu import DELTA_REJECT_REASONS, GPUSolver
from test_torch_fixtures import CHAIN_DIR, CHAINS, STATE_LEAVES, corpus_snapshot

torch.set_num_threads(1)

SMALL_CHAINS = sorted(n for n in CHAINS if n.startswith("chain_small_"))


@pytest.fixture(autouse=True)
def _fresh_highwater():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()


def _as_carry(leaves):
    return tuple(leaves[:7]) + (tuple(leaves[7:]),)


def _assert_state(got, ref, prefix, what):
    for leaf, a in zip(STATE_LEAVES, list(got[:7]) + list(got[7])):
        want = torch.as_tensor(ref[f"{prefix}_{leaf}"])
        assert a.dtype == want.dtype and torch.equal(a, want.reshape(a.shape)), f"{what}: {leaf}"


def _load(name, monkeypatch):
    problems, ref = load_chain(CHAIN_DIR / f"{name}.npz")
    for entry in ref["env"]:
        key, value = str(entry).split("=", 1)
        monkeypatch.setenv(key, value)
    return problems, ref


@pytest.mark.parametrize("name", SMALL_CHAINS)
def test_chain_through_gpusolver_equals_reference(name, monkeypatch):
    problems, ref = _load(name, monkeypatch)
    solver = GPUSolver(device="cpu")
    for i, problem in enumerate(problems):
        pre = f"s{i}."
        res = solver.solve_encoded(problem)
        what = f"{name} step {i}"
        assert solver.last_solve_mode == str(ref[pre + "ref_mode"]), what
        assert (solver.last_delta_reject or "") == str(ref[pre + "ref_reject"]), what
        assert res.errors == [], what
        resident = solver._resident
        assert resident["problem"] is problem, what
        np.testing.assert_array_equal(res.assignment, ref[pre + "ref_assignment"], err_msg=what)
        np.testing.assert_array_equal(resident["assignment"], ref[pre + "ref_assignment"], err_msg=what)
        np.testing.assert_array_equal(resident["slot_basis"], ref[pre + "ref_slot_basis"], err_msg=what)
        np.testing.assert_array_equal(resident["slot_zoneset"], ref[pre + "ref_slot_zoneset"], err_msg=what)
        assert res.open_count == int(ref[pre + "ref_open_count"]), what
        assert resident["t"].n_slots == int(ref[pre + "ref_n_slots"]), what
        _assert_state(resident["state"], ref, pre + "ref_state", what)


def test_chains_reach_every_delta_branch(monkeypatch):
    """Together the small chains take every branch of the delta solve: each
    reject reason, a recredit of spread, hostname and zone-anti members, a
    port rebuild, a bind flush with and without port changes, a demoted
    append, growth of the signature axis and an identical resubmit."""
    reasons, kinds = set(), set()
    for name in SMALL_CHAINS:
        monkeypatch.delenv("KARPENTER_SOLVER_MULTIGROUP", raising=False)
        problems, ref = _load(name, monkeypatch)
        for i, p in enumerate(problems):
            pre = f"s{i}."
            reasons.add(str(ref[pre + "ref_reject"]))
            d = p.delta
            if d is None:
                continue
            base = d.base
            if d.row_diff is not None:
                kinds.add("row-diff-ports" if d.row_diff.ports_changed else "row-diff")
            if not d.added_sigs.size and not d.removed_enc.size and d.row_diff is None:
                kinds.add("resubmit")
            if d.added_sigs.size and int(d.added_sigs.max()) >= base.n_sigs:
                kinds.add("growth")
            if pre + "rc_zmem" in ref:
                kinds.update(k for k, hit in (("zone", ref[pre + "rc_zmem"].any()), ("host", ref[pre + "rc_hmem"].any()))
                             if hit)
            rsig = base.sig_of_pod[d.removed_enc]
            kind_of = p.group_kind
            touch = (p.sig_member[rsig] | p.sig_owner[rsig])[:, : kind_of.shape[0]]
            if (touch & (kind_of == 3)).any():
                kinds.add("anti")
            if p.sig_port_any[rsig].any():
                kinds.add("ports")
            if d.added_sigs.size and tsg.sig_demotions(p)[0][d.added_sigs].any():
                kinds.add("demoted")
    assert reasons >= set(DELTA_REJECT_REASONS) | {""}
    assert kinds >= {"row-diff", "row-diff-ports", "resubmit", "growth", "zone", "host", "anti", "ports", "demoted"}


@pytest.mark.parametrize("name", SMALL_CHAINS)
def test_delta_pack_on_recorded_carry_equals_reference(name, monkeypatch):
    """Each recorded delta pack, re-run by the port from the recorded input
    carry with the port's own delta items and tensors, gives the
    reference's flat output and final carry."""
    problems, ref = _load(name, monkeypatch)
    calls = []
    real = tsg.greedy_pack_delta_compressed

    def spy(state, t, items, n_added):
        out = real(state, t, items, n_added)
        calls.append((state, out))
        return out

    monkeypatch.setattr("karpenter_tpu_torch.solver.gpu.greedy_pack_delta_compressed", spy)
    solver = GPUSolver(device="cpu")
    for i, problem in enumerate(problems):
        pre = f"s{i}."
        calls.clear()
        solver.solve_encoded(problem)
        if pre + "dp_flat" not in ref:
            assert not calls
            continue
        (state_in, out), = calls
        _assert_state(state_in, ref, pre + "dp_in", f"{name} step {i} input carry")
        assert out["nnz_cap"] == int(ref[pre + "dp_nnz_cap"])
        np.testing.assert_array_equal(out["flat"].numpy(), ref[pre + "dp_flat"])
        _assert_state(out["state"], ref, pre + "dp_out", f"{name} step {i} output carry")


# -- the carry edits against the reference's static methods ------------------------


def _pair(name, n_slots=None):
    """A JAX encode, its port problem, the two packages' tensors and one
    shared carry (the JAX pack's final state) in both forms."""
    from karpenter_tpu.models import scheduler_model_grouped as jsg

    enc = encode(corpus_snapshot(name))
    p = from_reference(enc)
    cap = n_slots or enc.n_existing + min(enc.n_pods, 4096)
    jt = jsm.make_tensors(enc, n_slots=cap, with_pods=False)
    tt = tsm.make_tensors(p, "cpu", n_slots=cap)
    arrays, _pods = jsg.build_items(enc)
    out = jsg.greedy_pack_grouped_compressed(jt, jsg.make_item_tensors(arrays), enc.n_pods)
    jstate = out["state"]
    tstate = _as_carry([torch.as_tensor(np.array(x)) for x in list(jstate[:7]) + list(jstate[7])])
    return enc, p, jt, tt, jstate, tstate, out


def _assert_same_state(tstate, jstate, what):
    for leaf, a, b in zip(STATE_LEAVES, list(tstate[:7]) + list(tstate[7]), list(jstate[:7]) + list(jstate[7])):
        want = torch.as_tensor(np.array(b))
        assert a.dtype == want.dtype and torch.equal(a, want.reshape(a.shape)), f"{what}: {leaf}"


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_row_diff_equals_reference(seed):
    rng = np.random.default_rng(seed)
    enc, p, jt, tt, jstate, tstate, _out = _pair("small_existing_ports_inverse")
    E, R = enc.n_existing, enc.row_alloc.shape[1]
    G, D = enc.counts_dom_init.shape
    # a refreshed encode: new existing-row values; the diff carries their shift
    alloc = enc.row_alloc.copy()
    alloc[:E] = alloc[:E] - rng.integers(0, 4, (E, R)).astype(np.float32) * np.float32(0.25)
    cdi = enc.counts_dom_init + rng.integers(0, 3, (G, D)).astype(np.int32)
    che = enc.counts_host_existing + rng.integers(0, 2, enc.counts_host_existing.shape).astype(np.int32)
    reg = enc.group_registered | (rng.random((G, D)) < 0.3)
    epa = rng.random(enc.existing_port_any.shape) < 0.5
    epw = rng.random(enc.existing_port_wild.shape) < 0.5
    eps = rng.random(enc.existing_port_spec.shape) < 0.5
    enc2 = dataclasses.replace(enc, row_alloc=alloc, counts_dom_init=cdi, counts_host_existing=che,
                               group_registered=reg, existing_port_any=epa, existing_port_wild=epw,
                               existing_port_spec=eps)
    diff = dict(n_existing=E, alloc=alloc[:E] - enc.row_alloc[:E], counts_dom=cdi - enc.counts_dom_init,
                counts_host=che - enc.counts_host_existing, ports_changed=True)
    jstate2, jt2 = TPUSolver._apply_row_diff(jstate, jt, enc2, diff)
    p2 = from_reference(enc2)
    tstate2, tt2 = carry.apply_row_diff(tstate, tt, p2, RowDiff(**diff))
    _assert_same_state(tstate2, jstate2, "carry")
    for f in ("row_alloc", "counts_dom_init", "counts_host_init", "group_registered", "existing_port_any",
              "existing_port_wild", "existing_port_spec", "row_labels", "existing_domset"):
        a, b = getattr(tt2, f), np.array(getattr(jt2, f))
        assert torch.equal(a, torch.as_tensor(b)), f


def test_recount_anti_groups_equals_reference():
    rng = np.random.default_rng(3)
    enc, p, jt, tt, jstate, tstate, out = _pair("small_spread_anti_ports")
    anti_groups = np.nonzero(np.asarray(enc.group_kind) == 3)[0]
    assert anti_groups.size
    zoneset = np.asarray(out["slot_zoneset"])
    open_count = int(out["open_count"])
    surv = np.sort(rng.choice(enc.n_pods, enc.n_pods - 5, replace=False))
    surv_sigs = np.asarray(enc.sig_of_pod)[surv]
    surv_assign = rng.integers(-1, open_count, surv.size)
    want = TPUSolver._recount_anti_groups(enc, zoneset, jstate, anti_groups, surv_sigs, surv_assign)
    got = carry.recount_anti_groups(p, zoneset, tstate, anti_groups, surv_sigs, surv_assign)
    _assert_same_state(got, want, "recount")
    assert not torch.equal(got[4], tstate[4])  # the rows really changed


def test_rebuild_port_planes_equals_reference():
    rng = np.random.default_rng(4)
    enc, p, jt, tt, jstate, tstate, out = _pair("small_existing_ports_inverse")
    open_count = int(out["open_count"])
    surv_sigs = np.asarray(enc.sig_of_pod)
    surv_assign = rng.integers(-1, open_count, surv_sigs.size)
    want = TPUSolver._rebuild_port_planes(enc, jt, jstate, surv_sigs, surv_assign)
    got = carry.rebuild_port_planes(p, tt, tstate, surv_sigs, surv_assign)
    for a, b in zip(got, want):
        assert torch.equal(a, torch.as_tensor(np.array(b)))
    assert any(bool(x.any()) for x in got)


def test_delta_without_resident_or_base_takes_full_path():
    """No resident carry, or a delta whose base is not the resident problem:
    "no-carry" and the full pack, as the reference does."""
    problems, _ref = load_chain(CHAIN_DIR / "chain_small_irreversible.npz")
    solver = GPUSolver(device="cpu")
    solver.solve_encoded(problems[2])
    assert (solver.last_solve_mode, solver.last_delta_reject) == ("full", "no-carry")
    solver.solve_encoded(problems[3])  # its base is problems[2], which is resident: a delta
    assert solver.last_solve_mode == "delta"
    solver.solve_encoded(problems[2])  # its base (problems[1]) is not resident
    assert (solver.last_solve_mode, solver.last_delta_reject) == ("full", "no-carry")
    # a problem without a delta is its own base: solved in full once, then
    # resubmitted it revalidates from its own carry
    plain = dataclasses.replace(problems[2], delta=None)
    res = solver.solve_encoded(plain)
    assert (solver.last_solve_mode, solver.last_delta_reject) == ("full", "no-carry")
    again = solver.solve_encoded(plain)
    assert (solver.last_solve_mode, solver.last_delta_reject) == ("delta", None) and again.errors == []
    np.testing.assert_array_equal(again.assignment, res.assignment)
    assert again.flat is None and again.items is None and again.open_count == res.open_count


def test_recredit_width_mismatch_raises_like_reference():
    """The reference's scatter cannot broadcast a request narrower than the
    carry's resource axis and raises; so does the port."""
    enc, p, jt, tt, jstate, tstate, _out = _pair("small_spread_anti_ports")
    G = int(tt.group_kind.shape[0])
    args = (np.array([0], np.int32), enc.sig_req[:1, :-1], np.zeros((1, G), bool), np.zeros((1, G), bool))
    with pytest.raises(ValueError):
        tsg.recredit_removals(tstate, tt, *args)
    from karpenter_tpu.models import scheduler_model_grouped as jsg

    with pytest.raises(ValueError):
        jsg.recredit_removals(jstate, jt, *args)
