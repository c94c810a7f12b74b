"""`recredit_plain` (the plain version of kernel K4) against the JAX
`_recredit_impl`, on the CPU.

Random carries with removals that share slots and carry f32 values whose
sum depends on the order they are added in, padding entries (slot -1),
spread and hostname members and removals with no spread group (k* = -1);
then every recredit the reference made in the chain fixtures, the headline
churn chain included. Tolerance: exact (`torch.equal` on every leaf): the
reference's XLA:CPU scatter adds the removals in order, k = 0..K-1, one
rounding per add, and the plain version adds in the same order.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.models import scheduler_model as jsm
from karpenter_tpu.models import scheduler_model_grouped as jsg
from karpenter_tpu.solver.encode import encode
from karpenter_tpu_torch.kernels import build
from karpenter_tpu_torch.kernels.recredit import recredit, recredit_plain
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.models import scheduler_model_grouped as tsg
from karpenter_tpu_torch.solver.encoded import load_chain
from test_torch_fixtures import CHAIN_DIR, CHAINS, STATE_LEAVES, corpus_snapshot

torch.set_num_threads(1)

TINY = 2.0**-24  # half an ulp of 1.0: 1 + TINY rounds back to 1, TINY + TINY does not


@pytest.fixture(scope="module")
def jax_tensors():
    """The reference's tensors of a small problem (G = 8 groups, D = 5
    domains, N = 512 slots); only group_dom_key and dom_key_of are read."""
    jsm.reset_bucket_highwater()
    enc = encode(corpus_snapshot("small_spread_anti_ports"))
    t = jsm.make_tensors(enc, n_slots=8, with_pods=False)
    jsm.reset_bucket_highwater()
    return t


def _random_case(t, seed: int, K: int = 48, n_pad: int = 8):
    rng = np.random.default_rng(seed)
    N = t.n_slots
    R = int(t.row_alloc.shape[1])
    G, D = (int(x) for x in t.counts_dom_init.shape)
    group_dom_key = rng.integers(-1, 3, G).astype(np.int32)
    dom_key_of = rng.integers(0, 3, D).astype(np.int32)
    slot_rem = (rng.standard_normal((N, R)) * rng.choice([1.0, 1e3, 1e-3], (N, R))).astype(np.float32)
    slot_rem[0, 0] = -0.0
    hot = rng.integers(0, N, 4)  # removals pile onto a few slots
    slot_idx = rng.choice(hot, K).astype(np.int32)
    slot_idx[K - n_pad:] = -1
    req = (rng.standard_normal((K, R)) * rng.choice([1.0, 1e4, 1e-4, TINY], (K, R))).astype(np.float32)
    zmem = rng.random((K, G)) < 0.3
    zmem[::5] = False  # no spread group: k* = -1
    hmem = rng.random((K, G)) < 0.3
    state = dict(
        slot_basis=rng.integers(-1, 50, N).astype(np.int32),
        slot_rem=slot_rem,
        slot_zoneset=rng.random((N, D)) < 0.5,
        slot_rank=rng.integers(-1, 4, N).astype(np.int32),
        counts_zone=rng.integers(0, 50, (G, D)).astype(np.int32),
        counts_host=rng.integers(0, 5, (G, N)).astype(np.int32),
        open_count=np.int32(N // 2),
        port_any=rng.random((N, 4)) < 0.2,
        port_wild=rng.random((N, 4)) < 0.2,
        port_spec=rng.random((N, 4)) < 0.2,
    )
    return group_dom_key, dom_key_of, state, slot_idx, req, zmem, hmem


def _carry(state: dict, as_tensor):
    leaves = [as_tensor(state[k]) for k in STATE_LEAVES]
    return tuple(leaves[:7]) + (tuple(leaves[7:]),)


def _both(t, group_dom_key, dom_key_of, state, slot_idx, req, zmem, hmem):
    """(reference carry, plain carry) on the same inputs."""
    import dataclasses

    jt = dataclasses.replace(t, group_dom_key=jnp.asarray(group_dom_key), dom_key_of=jnp.asarray(dom_key_of))
    want = jsg._recredit_impl(_carry(state, jnp.asarray), jt, jnp.asarray(slot_idx), jnp.asarray(req),
                              jnp.asarray(zmem), jnp.asarray(hmem))
    tt = types.SimpleNamespace(group_dom_key=torch.as_tensor(group_dom_key), dom_key_of=torch.as_tensor(dom_key_of))
    got = recredit_plain(_carry(state, lambda a: torch.as_tensor(np.array(a))), tt, torch.as_tensor(slot_idx),
                         torch.as_tensor(req), torch.as_tensor(zmem), torch.as_tensor(hmem))
    return want, got


def _assert_equal(got, want):
    for leaf, a, b in zip(STATE_LEAVES, list(got[:7]) + list(got[7]), list(want[:7]) + list(want[7])):
        b = torch.as_tensor(np.array(b))
        assert a.dtype == b.dtype, leaf
        # bit equality: -0.0 and +0.0 differ here
        if a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), leaf
        else:
            assert torch.equal(a, b.reshape(a.shape)), leaf


@pytest.mark.parametrize("seed", range(6))
def test_recredit_plain_equals_reference_on_random_carries(jax_tensors, seed):
    case = _random_case(jax_tensors, seed)
    want, got = _both(jax_tensors, *case)
    _assert_equal(got, want)
    assert not torch.equal(got[1], torch.as_tensor(case[2]["slot_rem"]))


def test_duplicate_slots_add_in_removal_order(jax_tensors):
    """1 + TINY + TINY is 1 added in order and 1 + 2 TINY summed first;
    0 - 1 + TINY + 1 is TINY in order and 0 in reverse. The reference gives
    the in-order values, and so does the plain version."""
    gdk, dko, state, slot_idx, req, zmem, hmem = _random_case(jax_tensors, 0)
    state["slot_rem"][3] = 1.0
    state["slot_rem"][5] = 0.0
    slot_idx[:] = -1
    slot_idx[:5] = (3, 5, 3, 5, 5)
    req[:] = 0.0
    req[:5] = np.array([TINY, -1.0, TINY, TINY, 1.0], np.float32)[:, None]
    want, got = _both(jax_tensors, gdk, dko, state, slot_idx, req, zmem, hmem)
    _assert_equal(got, want)
    assert got[1][3, 0].item() == 1.0 and got[1][5, 0].item() == TINY
    f = np.float32
    assert f(1.0) + (f(TINY) + f(TINY)) != f(1.0)  # another order would show
    assert ((f(0.0) + f(1.0)) + f(TINY)) + f(-1.0) != f(TINY)


def test_padding_turns_negative_zero_at_slot_zero_positive(jax_tensors):
    """Padding entries clip to slot 0 and add +0.0 there, as the reference's
    scatter does: a -0.0 in slot 0 becomes +0.0."""
    gdk, dko, state, slot_idx, req, zmem, hmem = _random_case(jax_tensors, 1)
    state["slot_rem"][0] = -0.0
    slot_idx[:] = -1
    want, got = _both(jax_tensors, gdk, dko, state, slot_idx, req, zmem, hmem)
    _assert_equal(got, want)
    assert not torch.signbit(got[1][0]).any()


def test_no_spread_membership_selects_no_domain(jax_tensors):
    """k* = -1 (no spread group) must match no domain: counts_zone is left
    alone while the capacity and hostname counts still move."""
    gdk, dko, state, slot_idx, req, zmem, hmem = _random_case(jax_tensors, 2)
    zmem[:] = False
    hmem[:] = True
    want, got = _both(jax_tensors, gdk, dko, state, slot_idx, req, zmem, hmem)
    _assert_equal(got, want)
    assert torch.equal(got[4], torch.as_tensor(state["counts_zone"]))
    assert not torch.equal(got[5], torch.as_tensor(state["counts_host"]))


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_recorded_recredits_of_the_chains(name):
    """Every recredit the reference made in a chain (the removals as its
    solver passed them, padded here by `recredit_removals`) equals the
    recorded output carry."""
    problems, ref = load_chain(CHAIN_DIR / f"{name}.npz")
    n = 0
    for i, p in enumerate(problems):
        pre = f"s{i}."
        if pre + "rc_slot_idx" not in ref:
            continue
        G_p = ref[pre + "rc_zmem"].shape[1]
        gdk = np.full(G_p, -1, np.int32)
        gdk[: p.n_groups] = p.group_dom_key
        t = types.SimpleNamespace(group_dom_key=torch.as_tensor(gdk), dom_key_of=torch.as_tensor(p.dom_key_of))
        state = _carry({k: ref[f"{pre}rc_in_{k}"] for k in STATE_LEAVES}, torch.as_tensor)
        tsm.reset_bucket_highwater()
        build.reset_launches()
        got = tsg.recredit_removals(state, t, ref[pre + "rc_slot_idx"], ref[pre + "rc_req"], ref[pre + "rc_zmem"],
                                    ref[pre + "rc_hmem"])
        assert build.LAUNCHES["recredit"] == 0  # CPU tensors: the plain version
        want = _carry({k: ref[f"{pre}rc_out_{k}"] for k in STATE_LEAVES}, torch.as_tensor)
        _assert_equal(got, want)
        n += 1
    assert n or name == "chain_small_slot_exhausted"


def test_wrapper_runs_plain_version_only_on_cpu(jax_tensors):
    gdk, dko, state, slot_idx, req, zmem, hmem = _random_case(jax_tensors, 5)
    tt = types.SimpleNamespace(group_dom_key=torch.as_tensor(gdk), dom_key_of=torch.as_tensor(dko))
    carry = _carry(state, lambda a: torch.as_tensor(np.array(a)))
    args = [torch.as_tensor(x) for x in (slot_idx, req, zmem, hmem)]
    build.reset_launches()
    got = recredit(carry, tt, *args)
    _assert_equal(got, recredit_plain(carry, tt, *args))
    assert build.LAUNCHES["recredit"] == 0
    with pytest.raises(ValueError):
        recredit(carry, tt, args[0].to("meta"), *args[1:])
