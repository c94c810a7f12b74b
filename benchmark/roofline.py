"""A kernel's share of its roofline: the least time the card could take
for the work, over the time it took.

The peaks are NVIDIA's published ones for one H100 SXM at its 700 W limit
(HBM3 bandwidth and the float32 rate outside the tensor cores; the kernels
compute in float32 and integers). The operation and byte counts are the
repo's bring-up smoke test's (`k2_cost`, `place_calls`),
copied here so a change to the program cannot move them: each input byte
is read once and each output byte written once."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def nbytes(*tensors) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tensors)


def bound_s(n_bytes: float, ops: float) -> float:
    """The larger of bytes over the peak memory rate and operations over the
    peak float32 rate, in seconds."""
    return max(n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S)


def place_calls(t, items) -> int:
    """place() calls K2's scan makes for these items (per branch: simple 1,
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


def k2_cost(t, items, compat, key, n_slots: int, state, takes, left) -> tuple[int, int]:
    """K2 (pack_scan): the carry, the item and row inputs read once; takes,
    leftovers and the final carry written once. Operations: each place()
    call touches every slot with ~(3R + 3DR + 12) f32/int operations."""
    R = items.item_req.shape[1]
    D = t.counts_dom_init.shape[1]
    carry = list(state[:7]) + list(state[7])
    t_in = nbytes(t.row_alloc, t.row_pool_rank, t.rank_domset, t.rank_dom_cap, t.dom_key_of, t.group_kind,
                  t.group_skew, t.group_dom_key, t.group_min_domains, t.group_registered, t.row_port_any,
                  t.row_port_wild, t.row_port_spec)
    i_in = nbytes(items.item_req, items.item_dom_allowed, items.item_restrict, items.item_member, items.item_owner,
                  items.item_count, items.item_port_any, items.item_port_wild, items.item_port_spec,
                  items.item_host_blocked, compat, key)
    return (t_in + i_in + 2 * nbytes(*carry) + nbytes(takes, left),
            place_calls(t, items) * int(n_slots) * (3 * R + 3 * D * R + 12))

