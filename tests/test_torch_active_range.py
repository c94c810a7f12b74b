"""The invariant that the pack kernel's active slot range rests on.

K2 (`karpenter_tpu_torch/kernels/csrc/pack_scan.cu`) works only on the open
slots, `[0, open_count)` and those it opens, and hands every slot past them
back as it came in. That is exact because a slot past `open_count` is
closed in every carry the solver builds: basis -1, rank -1, no domain or
port bits, no hostname counts and no takes, and its capacity (not zero)
is never written. These tests pin that on the plain pack of every fixture,
on every carry of every chain step that the JAX solver recorded (the
resident carry, the recredit's input and output, the delta pack's input and
output with its takes) and on the dense pack.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.models import scheduler_model_grouped as tsg
from karpenter_tpu_torch.solver.encoded import load_npz
from test_torch_fixtures import CHAIN_DIR, CHAINS, CORPUS, FIXTURE_DIR, STATE_LEAVES

# the plain scan is thousands of tiny ops: one intra-op thread per test worker
torch.set_num_threads(1)


def _steps(name: str) -> int:
    with np.load(CHAIN_DIR / f"{name}.npz", allow_pickle=False) as z:
        return int(z["n_steps"])


CHAIN_STEPS = [(name, i) for name in sorted(CHAINS) for i in range(_steps(name))]


def assert_closed_past_open(leaves: dict, what: str, rem_in=None, takes=None) -> int:
    """Every slot past the carry's open count is closed; its capacity is
    `rem_in`'s bit for bit, and it holds no takes. Returns the open count."""
    n = int(leaves["open_count"])
    assert 0 <= n <= leaves["slot_basis"].shape[0], what
    assert (leaves["slot_basis"][n:] == -1).all(), f"{what}: basis past open_count"
    assert (leaves["slot_rank"][n:] == -1).all(), f"{what}: rank past open_count"
    for leaf in ("slot_zoneset", "port_any", "port_wild", "port_spec"):
        assert not leaves[leaf][n:].any(), f"{what}: {leaf} past open_count"
    assert (leaves["counts_host"][:, n:] == 0).all(), f"{what}: counts_host past open_count"
    if rem_in is not None:
        np.testing.assert_array_equal(leaves["slot_rem"][n:].view(np.int32), rem_in[n:].view(np.int32),
                                      err_msg=f"{what}: slot_rem past open_count")
    if takes is not None:
        assert (takes[:, n:] == 0).all(), f"{what}: takes past open_count"
    return n


def _numpy_carry(state) -> dict:
    leaves = list(state[:7]) + list(state[7])
    return {k: np.asarray(v) for k, v in zip(STATE_LEAVES, leaves)}


def _stored(ref: dict, prefix: str) -> dict:
    return {k: ref[f"{prefix}_{k}"] for k in STATE_LEAVES}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_plain_pack_keeps_slots_past_open_count(name):
    """The plain pack of every fixture: the carry it receives and the one
    it returns are closed past their open counts; the slots past the final
    count keep their capacity bit for bit and hold no takes."""
    tsm.reset_bucket_highwater()
    problem, ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, "cpu")
    n_slots = int(ref["ref_n_slots"])
    t = tsm.make_tensors(problem, "cpu", n_slots=n_slots)
    init = _numpy_carry(tsg.initial_state(t, n_slots))
    assert assert_closed_past_open(init, f"{name} initial carry") == t.n_existing
    takes, _left, state = tsg._pack_body(t, items, n_slots=n_slots)
    out = _numpy_carry(state)
    n = assert_closed_past_open(out, f"{name} final carry", rem_in=init["slot_rem"], takes=takes.numpy())
    assert n == int(ref["ref_open_count"])
    assert (init["slot_rem"][n:] != 0).any(), f"{name}: the capacity past open_count is not all zero"


@pytest.mark.parametrize("name,step", CHAIN_STEPS)
def test_chain_carries_keep_slots_past_open_count(name, step):
    """Every carry the JAX solver recorded at this chain step: the resident
    carry after the step, the recredit's input and output (its removals
    touch open slots only) and the delta pack's input and output, whose
    takes (the flat output's triples) land on open slots only."""
    with np.load(CHAIN_DIR / f"{name}.npz", allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files if k.startswith(f"s{step}.")}
    pre = f"s{step}."
    checked = [assert_closed_past_open(_stored(ref, pre + "ref_state"), f"{name} step {step} resident carry")]
    if pre + "rc_slot_idx" in ref:
        rc_in = _stored(ref, pre + "rc_in")
        checked.append(assert_closed_past_open(rc_in, f"{name} step {step} recredit input"))
        n = assert_closed_past_open(_stored(ref, pre + "rc_out"), f"{name} step {step} recredit output",
                                    rem_in=rc_in["slot_rem"])
        assert n == int(rc_in["open_count"])
        assert (ref[pre + "rc_slot_idx"] < n).all(), f"{name} step {step}: a removal past open_count"
    if pre + "dp_flat" in ref:
        dp_in, dp_out = _stored(ref, pre + "dp_in"), _stored(ref, pre + "dp_out")
        assert_closed_past_open(dp_in, f"{name} step {step} delta pack input")
        N, Z = dp_out["slot_zoneset"].shape
        nnz = int(ref[pre + "dp_nnz_cap"])
        flat = ref[pre + "dp_flat"]
        W = flat.shape[0] - 3 * nnz - N - N * Z - 1
        out = tsg._parse_flat(flat, nnz, N, Z, W)
        takes = np.zeros((W, N), np.int32)
        ok = out["nz_item"] >= 0
        takes[out["nz_item"][ok], out["nz_slot"][ok]] = out["nz_count"][ok]
        n = assert_closed_past_open(dp_out, f"{name} step {step} delta pack output", rem_in=dp_in["slot_rem"],
                                    takes=takes)
        assert n == out["open_count"]
    assert checked


def test_dense_pack_keeps_slots_past_open_count():
    """`greedy_pack_grouped` (the dense takes) at the headline: no take, basis,
    rank or domain bit past the open count."""
    tsm.reset_bucket_highwater()
    problem, ref = load_npz(FIXTURE_DIR / "headline_5000x100.npz")
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, "cpu")
    t = tsm.make_tensors(problem, "cpu", n_slots=int(ref["ref_n_slots"]))
    takes, _left, basis, zoneset, rank, open_count = tsg.greedy_pack_grouped(t, items)
    n = int(open_count)
    assert n == int(ref["ref_open_count"])
    assert not takes[:, n:].any() and (basis[n:] == -1).all() and (rank[n:] == -1).all() and not zoneset[n:].any()
    assert (takes[:, :n].sum(dim=0) > 0).any()
