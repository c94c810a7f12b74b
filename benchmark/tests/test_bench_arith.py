"""The benchmark's copied arithmetic on small cases: the roofline bound and
K2's counts."""

import types

import pytest
import torch
from bench_support import ROOT  # noqa: F401  (puts the repo on the path)

from benchmark import roofline


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def t32(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


def test_k2_counts():
    W, N, T, D, G, R = 3, 8, 5, 4, 2, 3
    t = types.SimpleNamespace(
        counts_dom_init=t32(G, D), group_kind=torch.tensor([0, 3], dtype=torch.int32),
        row_alloc=t32(T, R, dtype=torch.float32), row_pool_rank=t32(T), rank_domset=t32(T, D), rank_dom_cap=t32(T, D),
        dom_key_of=t32(D), group_skew=t32(G), group_dom_key=t32(G), group_min_domains=t32(G), group_registered=t32(G),
        row_port_any=t32(T), row_port_wild=t32(T), row_port_spec=t32(T))
    member = torch.tensor([[False, False], [True, False], [False, True]])
    items = types.SimpleNamespace(
        item_req=t32(W, R, dtype=torch.float32), item_dom_allowed=t32(W, D), item_restrict=t32(W), item_member=member,
        item_owner=t32(W), item_count=t32(W), item_port_any=t32(W), item_port_wild=t32(W), item_port_spec=t32(W),
        item_host_blocked=t32(W))
    # item 0 simple (1 call), item 1 zone-spread (2D), item 2 zone anti-affinity (D + 1)
    assert roofline.place_calls(t, items) == 1 + 2 * D + D + 1
    compat, key = t32(W, T, dtype=torch.bool), t32(W)
    state = (t32(N), t32(N, R, dtype=torch.float32), t32(N, D, dtype=torch.bool), t32(N), t32(G, D), t32(G, N), t32(1),
             (t32(N), t32(N), t32(N)))
    takes, left = t32(W, N), t32(W)
    b, o = roofline.k2_cost(t, items, compat, key, N, state, takes, left)
    t_in = 4 * (T * R + T + 2 * T * D + D + 5 * G + 3 * T)
    i_in = 4 * (W * R + W * D + 7 * W) + W * G + W * T + 4 * W
    carry = 4 * (N + N * R + N + G * D + G * N + 1 + 3 * N) + N * D
    assert b == t_in + i_in + 2 * carry + 4 * (W * N + W)
    assert o == (1 + 3 * D + 1) * N * (3 * R + 3 * D * R + 12)

