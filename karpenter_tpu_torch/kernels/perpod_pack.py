"""K8 perpod_pack: the per-pod FFD scan as one persistent CUDA block.

`perpod_pack` launches `csrc/perpod_pack.cu` for CUDA tensors and runs the
plain `greedy_pack_plain` for CPU tensors. The kernel updates a copy of the
initial carry in place and returns it as the final carry, in the plain
version's order: (assignment, slot_basis, slot_domset, slot_rank,
open_count, slot_rem, counts_dom, counts_host)."""

from __future__ import annotations

import ctypes

import torch

from ..models.scheduler_model import greedy_pack_plain
from . import build

perpod_pack_plain = greedy_pack_plain


def perpod_pack(t, pods, compat, key):
    """K8 on CUDA tensors, the plain version on CPU tensors. compat and key
    are K1's [P, Nrows] outputs over the pods."""
    from ..models.scheduler_model_grouped import initial_state

    dev = pods.pod_req.device
    if dev.type == "cpu":
        return greedy_pack_plain(t, pods, compat, key)
    if dev.type != "cuda":
        raise ValueError(f"perpod_pack: unsupported device {dev}")
    P, R = pods.pod_req.shape
    N = t.n_slots
    Nrows = t.row_alloc.shape[0]
    G, D = t.counts_dom_init.shape
    Q = t.rank_domset.shape[0]
    Kd = pods.pod_restrict.shape[1]
    if compat.shape != (P, Nrows) or key.shape != (P, Nrows):
        raise ValueError("perpod_pack: feasibility outputs do not match the pods")
    if pods.member.shape != (P, G) or pods.owner.shape != (P, G) or pods.pod_dom_allowed.shape != (P, D):
        raise ValueError("perpod_pack: pod and group axes disagree")

    st = initial_state(t, N)
    carry = [x.clone().contiguous() for x in (st[0], st[1], st[2], st[3], st[4], st[5], st[6].reshape(1))]
    assignment = torch.full((P,), -1, dtype=torch.int32, device=dev)
    d_arr = (ctypes.c_int * 10)(P, N, Nrows, R, D, G, Q, Kd, int(t.n_existing), int(t.n_rows_real))
    scratch = torch.empty(build.lib().kt_perpod_pack_scratch(ctypes.addressof(d_arr)), dtype=torch.int32, device=dev)
    b, f, i = torch.bool, torch.float32, torch.int32
    inputs = [
        (t.row_alloc, f), (t.row_pool_rank, i), (t.rank_domset, b), (t.dom_key_of, i), (t.group_kind, i),
        (t.group_skew, i), (t.group_dom_key, i), (t.group_min_domains, i), (t.group_registered, b),
        (pods.pod_req, f), (pods.pod_dom_allowed, b), (pods.pod_restrict, b), (pods.member, b), (pods.owner, b),
        (compat, b), (key, f),
    ]
    carry_types = (i, f, b, i, i, i, i)
    ptrs = [build.require(x, dev, dt, f"input {k}").data_ptr() for k, (x, dt) in enumerate(inputs)]
    ptrs += [build.require(x, dev, dt, f"carry {k}").data_ptr() for k, (x, dt) in enumerate(zip(carry, carry_types))]
    ptrs += [assignment.data_ptr(), scratch.data_ptr()]
    p_arr = (ctypes.c_longlong * len(ptrs))(*ptrs)
    rc = build.lib().kt_perpod_pack(ctypes.addressof(p_arr), ctypes.addressof(d_arr), build.stream_ptr(dev))
    build.check(rc, "perpod_pack")
    build.LAUNCHES["perpod_pack"] += 1
    slot_basis, slot_rem, slot_domset, slot_rank, counts_dom, counts_host, open_count = carry
    return assignment, slot_basis, slot_domset, slot_rank, open_count.reshape(()), slot_rem, counts_dom, counts_host
