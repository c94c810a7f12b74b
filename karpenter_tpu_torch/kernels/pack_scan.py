"""K2 pack_scan: the grouped pack scan in one persistent CUDA block, with
helper blocks of the same launch that first build the items' data.

`pack_scan` launches `csrc/pack_scan.cu` for CUDA tensors and runs the plain
`_pack_body` for CPU tensors. The carry is copied from `init_state` (or
built by `initial_state`) into fresh buffers that the kernel updates in
place; they are returned as the final carry, in `initial_state`'s layout,
so a later pack can start from them. The kernel touches only the open slots
(`[0, open_count)` and those it opens): the slots past them come back as
they went in."""

from __future__ import annotations

import ctypes

import torch

from ..models.scheduler_model_grouped import _pack_body, initial_state
from . import build

pack_scan_plain = _pack_body


def pack_scan(t, items, compat, key, *, n_slots: int, init_state=None):
    """Returns (takes [W, N] i32, leftovers [W] i32, final carry)."""
    dev = items.item_req.device
    if dev.type == "cpu":
        return _pack_body(t, items, n_slots=n_slots, init_state=init_state, precomputed=(compat, key))
    if dev.type != "cuda":
        raise build.KernelArgError(f"pack_scan: unsupported device {dev}")
    W, R = items.item_req.shape
    N = int(n_slots)
    Nrows = t.row_alloc.shape[0]
    G, D = t.counts_dom_init.shape
    Q = t.rank_domset.shape[0]
    Kd = items.item_restrict.shape[1]
    P1 = items.item_port_any.shape[1]
    P2 = items.item_port_spec.shape[1]
    HB = items.item_host_blocked.shape[1]
    if compat.shape != (W, Nrows) or key.shape != (W, Nrows):
        raise build.KernelArgError("pack_scan: feasibility outputs do not match the items")

    st = init_state if init_state is not None else initial_state(t, N)
    slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports = st
    carry = [x.clone().contiguous() for x in (slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone,
                                              counts_host, open_count.reshape(1), *ports)]
    if carry[0].shape != (N,) or carry[1].shape != (N, R) or carry[5].shape != (G, N):
        raise build.KernelArgError("pack_scan: carry does not match n_slots")
    d_arr = (ctypes.c_int * 13)(W, N, Nrows, R, D, G, Q, Kd, P1, P2, HB, int(t.n_existing), int(t.n_rows_real))
    takes = torch.zeros((W, N), dtype=torch.int32, device=dev)
    leftovers = torch.zeros(W, dtype=torch.int32, device=dev)
    scratch = torch.zeros(build.lib().kt_pack_scan_scratch(ctypes.addressof(d_arr)), dtype=torch.int32, device=dev)
    b, f, i = torch.bool, torch.float32, torch.int32
    inputs = [
        (t.row_alloc, f), (t.row_pool_rank, i), (t.rank_domset, b), (t.rank_dom_cap, f), (t.dom_key_of, i),
        (t.group_kind, i), (t.group_skew, i), (t.group_dom_key, i), (t.group_min_domains, i),
        (t.group_registered, b), (t.row_port_any, b), (t.row_port_wild, b), (t.row_port_spec, b),
        (items.item_req, f), (items.item_dom_allowed, b), (items.item_restrict, b), (items.item_member, b),
        (items.item_owner, b), (items.item_count, i), (items.item_port_any, b), (items.item_port_wild, b),
        (items.item_port_spec, b), (items.item_host_blocked, b), (compat, b), (key, f),
    ]
    carry_types = (i, f, b, i, i, i, i, b, b, b)
    ptrs = [build.require(x, dev, dt, f"input {k}").data_ptr() for k, (x, dt) in enumerate(inputs)]
    ptrs += [build.require(x, dev, dt, f"carry {k}").data_ptr() for k, (x, dt) in enumerate(zip(carry, carry_types))]
    ptrs += [takes.data_ptr(), leftovers.data_ptr(), scratch.data_ptr()]
    p_arr = (ctypes.c_longlong * len(ptrs))(*ptrs)
    rc = build.lib().kt_pack_scan(ctypes.addressof(p_arr), ctypes.addressof(d_arr), build.stream_ptr(dev))
    build.check(rc, "pack_scan")
    build.LAUNCHES["pack_scan"] += 1
    state = (carry[0], carry[1], carry[2], carry[3], carry[4], carry[5], carry[6].reshape(()),
             (carry[7], carry[8], carry[9]))
    return takes, leftovers, state
