"""K1's plain version (compat_matrix + row_choose_key in PyTorch) against the
JAX reference, bit for bit, on seeded random inputs and on the fixtures.

Capacities that are exact multiples of the request are included on
purpose: the pack floors f32 quotients, so any inexact division (4000/1000
-> 3.9999998) would change a capacity."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu.models.scheduler_model import compat_matrix as ref_compat_matrix
from karpenter_tpu.models.scheduler_model import row_choose_key as ref_row_choose_key
from karpenter_tpu.ops.bitset import pack_bool_masks as ref_pack_bool_masks
from karpenter_tpu_torch.kernels.feasibility import feasibility, feasibility_plain
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.models import scheduler_model_grouped as tsg
from karpenter_tpu_torch.models.scheduler_model import compat_matrix, row_choose_key
from karpenter_tpu_torch.ops import bitset
from karpenter_tpu_torch.solver.encoded import load_npz
from test_torch_fixtures import CORPUS, FIXTURE_DIR

# the plain scan is thousands of tiny ops: one intra-op thread per test worker
torch.set_num_threads(1)


def _random_case(seed, W=24, Nrows=40, K=6, n_words=2, C=3, R=4):
    rng = np.random.default_rng(seed)
    bools = rng.random((W, K, n_words * 32 - 5)) < 0.7
    masks = ref_pack_bool_masks(bools)
    # label ids: absent (0), in range, past the last word, and negative
    labels = rng.integers(-2, n_words * 32 + 8, size=(Nrows, K)).astype(np.int32)
    taint_class = rng.integers(0, C, size=Nrows).astype(np.int32)
    taints_ok = rng.random((W, C)) < 0.8
    req = rng.choice(np.array([0.0, 0.25, 100.0, 250.0, 1000.0, 3.0], np.float32), size=(W, R)).astype(np.float32)
    mult = rng.integers(1, 64, size=(Nrows, R)).astype(np.float32)
    base = rng.choice(np.array([1000.0, 250.0, 0.25, 3.0, 7.0], np.float32), size=(Nrows, R)).astype(np.float32)
    alloc = (mult * base).astype(np.float32)  # many exact multiples of the requests
    alloc[rng.random((Nrows, R)) < 0.1] = np.float32(1e30)
    alloc[-2:] = np.float32(-3.4e38)  # pad rows
    rank = rng.integers(-1, 4, size=Nrows).astype(np.int32)
    dom_keys = tuple(int(k) for k in rng.choice([-1, 0, 2, K - 1], size=2))
    return masks, labels, taint_class, taints_ok, req, alloc, rank, dom_keys


@pytest.mark.parametrize("seed", range(6))
def test_plain_feasibility_matches_reference_random(seed):
    masks, labels, taint_class, taints_ok, req, alloc, rank, dom_keys = _random_case(seed)
    want_c = np.asarray(ref_compat_matrix(labels, taint_class, masks, taints_ok, dom_keys))
    want_k = np.asarray(ref_row_choose_key(alloc, rank, req))
    got_c = compat_matrix(torch.as_tensor(labels), torch.as_tensor(taint_class),
                          torch.as_tensor(bitset.as_int32_words(masks)), torch.as_tensor(taints_ok), dom_keys)
    got_k = row_choose_key(torch.as_tensor(alloc), torch.as_tensor(rank), torch.as_tensor(req))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert got_k.dtype == torch.float32
    np.testing.assert_array_equal(got_k.numpy().view(np.int32), want_k.view(np.int32))


def test_exact_multiple_capacities_floor_exactly():
    """alloc = k * req for every k: the integer capacity is exactly k."""
    req = torch.tensor([1000.0, 0.25, 3.0, 7.0], dtype=torch.float32)
    k = torch.arange(1, 4097, dtype=torch.float32)
    rem = k.unsqueeze(1) * req.unsqueeze(0)
    cap = tsg._int_cap(rem, req)
    assert torch.equal(cap, k.to(torch.int32))
    key = row_choose_key(rem, torch.zeros(k.shape[0], dtype=torch.int32), req.unsqueeze(0))[0]
    assert torch.equal(key, -torch.clamp_max(k, 1e8))


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_plain_feasibility_matches_reference_on_fixtures(name):
    problem, _ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    tsm.reset_bucket_highwater()
    arrays, _pods = tsg.build_items(problem)
    items = tsg.make_item_tensors(arrays, "cpu")
    t = tsm.make_tensors(problem, "cpu")
    compat, key = feasibility(t, items)
    c2, k2 = feasibility_plain(t, items)
    assert torch.equal(compat, c2) and torch.equal(key, k2)
    want_c = np.asarray(ref_compat_matrix(t.row_labels.numpy(), t.row_taint_class.numpy(), arrays["item_mask"],
                                          arrays["item_taint_ok"], t.dom_keys))
    want_k = np.asarray(ref_row_choose_key(t.row_alloc.numpy(), t.row_pool_rank.numpy(), arrays["item_req"]))
    np.testing.assert_array_equal(compat.numpy(), want_c)
    np.testing.assert_array_equal(key.numpy().view(np.int32), want_k.view(np.int32))


def test_bitset_helpers_match_reference():
    rng = np.random.default_rng(7)
    bools = rng.random((5, 3, 70)) < 0.5
    np.testing.assert_array_equal(bitset.pack_bool_masks(bools), ref_pack_bool_masks(bools))
    assert bitset.words_for(70) == 3 and bitset.words_for(0) == 1
    words = torch.as_tensor(bitset.as_int32_words(ref_pack_bool_masks(bools)))
    idx = torch.as_tensor(rng.integers(-3, 100, size=(5, 3)).astype(np.int32))
    got = bitset.test_bit(words, idx)
    w = np.clip(idx.numpy() // 32, 0, 2)
    want = np.zeros((5, 3), bool)
    for a in range(5):
        for b in range(3):
            i = int(idx[a, b])
            want[a, b] = i >= 0 and bool((int(ref_pack_bool_masks(bools)[a, b, w[a, b]]) >> (i % 32)) & 1)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the forced-key mask K1 reads (`SchedulerTensors.forced_keys`) -------------


def _reference_forced(dom_keys, K):
    """The keys the reference's compat_matrix forces true, read from the
    reference itself: row k carries a negative id (never a match) at key k
    and the absent id elsewhere, the one mask allows everything, so row k
    is compatible exactly when key k is forced."""
    labels = np.zeros((K, K), np.int32)
    np.fill_diagonal(labels, -1)
    masks = np.full((1, K, 1), 0xFFFFFFFF, np.uint32)
    compat = ref_compat_matrix(labels, np.zeros(K, np.int32), masks, np.ones((1, 1), bool), tuple(dom_keys))
    return np.asarray(compat)[0]


PROVISIONING = sorted(p.stem for p in FIXTURE_DIR.glob("*.npz")) + ["caps/caps_groups", "caps/caps_wide"]


@pytest.mark.parametrize("name", PROVISIONING)
def test_forced_keys_field_matches_reference_on_fixtures(name):
    problem, _ref = load_npz(FIXTURE_DIR / f"{name}.npz")
    tsm.reset_bucket_highwater()
    t = tsm.make_tensors(problem, "cpu")
    K = t.row_labels.shape[1]
    assert t.forced_keys.dtype == torch.bool and t.forced_keys.shape == (K,)
    np.testing.assert_array_equal(t.forced_keys.numpy(), _reference_forced(t.dom_keys, K))


@pytest.mark.parametrize("seed", range(8))
def test_forced_key_mask_matches_reference_random(seed):
    """dom keys with -1 (absent), duplicates and ids at and past K."""
    rng = np.random.default_rng(seed)
    K = int(rng.integers(1, 24))
    dom_keys = tuple(int(k) for k in rng.integers(-1, K + 3, size=int(rng.integers(0, 12))))
    dom_keys += (-1, K) + dom_keys[:2]
    got = tsm.forced_key_mask(dom_keys, K, "cpu")
    assert got.dtype == torch.bool and got.shape == (K,)
    np.testing.assert_array_equal(got.numpy(), _reference_forced(dom_keys, K))


@pytest.mark.parametrize("case", ["edges", "wide", "none", "rows_1000"])
def test_wrapper_on_cpu_tensors_is_the_plain_version(case):
    """K1's wrapper on CPU tensors returns exactly `compat_and_key_plain`'s
    outputs, launches nothing, and both equal the reference on the card's
    edge cases (`chip_smoke.K1_CASES`, the ones small enough for the CPU)."""
    import chip_smoke

    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels.feasibility import compat_and_key, compat_and_key_plain

    t, masks, taints_ok, req = chip_smoke.k1_case(case, "cpu")
    build.reset_launches()
    compat, key = compat_and_key(t, masks, taints_ok, req)
    assert all(v == 0 for v in build.LAUNCHES.values())
    compat_p, key_p = compat_and_key_plain(t, masks, taints_ok, req)
    assert torch.equal(compat, compat_p) and torch.equal(key.view(torch.int32), key_p.view(torch.int32))
    np.testing.assert_array_equal(t.forced_keys.numpy(), _reference_forced(t.dom_keys, masks.shape[1]))
    if masks.shape[0]:
        want_c = np.asarray(ref_compat_matrix(t.row_labels.numpy(), t.row_taint_class.numpy(),
                                              masks.numpy().view(np.uint32), taints_ok.numpy(), t.dom_keys))
        want_k = np.asarray(ref_row_choose_key(t.row_alloc.numpy(), t.row_pool_rank.numpy(), req.numpy()))
        np.testing.assert_array_equal(compat.numpy(), want_c)
        np.testing.assert_array_equal(key.numpy().view(np.int32), want_k.view(np.int32))
