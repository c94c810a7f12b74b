"""K4 recredit: reverse removed pods' takes in a pack carry.

`recredit` launches `csrc/recredit.cu` for CUDA tensors and runs
`recredit_plain` for CPU tensors. Both return a new carry: `slot_rem`,
`counts_host` and `counts_zone` rewritten, the other leaves passed through
(a slot's domain narrowing and port planes are left as they are; the
solver rebuilds the ones that need it)."""

from __future__ import annotations

import torch

from . import build


def recredit_plain(state, t, slot_idx, req, zmem, hmem):
    """Plain version of the reference's `_recredit_impl`: per removal k
    (slot_idx -1 = padding), credit req[k] back to its slot, decrement its
    hostname counts (hmem) and its spread counts (zmem) at the slot's
    domains in the largest dom key among its spread groups. slot_rem adds in
    removal order, one rounding per add, as the reference's scatter does."""
    slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports = state
    N = slot_rem.shape[0]
    valid = slot_idx >= 0
    j = torch.clamp(slot_idx, 0, N - 1).to(torch.int64)
    upd = torch.where(valid.unsqueeze(1), req, torch.zeros((), dtype=req.dtype, device=req.device))
    rem = slot_rem.clone()
    for k in range(int(slot_idx.shape[0])):
        rem[j[k]] = rem[j[k]] + upd[k]
    hm = (hmem & valid.unsqueeze(1)).to(counts_host.dtype)  # [K, G]
    host = counts_host.index_add(1, j, -hm.T)
    zm = zmem & valid.unsqueeze(1)  # [K, G]
    kstar = torch.where(zm, t.group_dom_key.unsqueeze(0), -1).amax(dim=1)  # [K]
    dsel = slot_zoneset[j] & (t.dom_key_of.unsqueeze(0) == kstar.unsqueeze(1))  # [K, D]
    dec = (zm.unsqueeze(2) & dsel.unsqueeze(1)).sum(dim=0, dtype=counts_zone.dtype)  # [G, D]
    return (slot_basis, rem, slot_zoneset, slot_rank, counts_zone - dec, host, open_count, ports)


def recredit(state, t, slot_idx, req, zmem, hmem):
    """slot_idx [K] i32, req [K, R] f32, zmem / hmem [K, G] bool (spread and
    hostname-counted members); returns the new carry."""
    dev = slot_idx.device
    if dev.type == "cpu":
        return recredit_plain(state, t, slot_idx, req, zmem, hmem)
    if dev.type != "cuda":
        raise ValueError(f"recredit: unsupported device {dev}")
    slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports = state
    K = int(slot_idx.shape[0])
    N, R = slot_rem.shape
    G, D = counts_zone.shape
    if req.shape != (K, R) or zmem.shape != (K, G) or hmem.shape != (K, G):
        raise ValueError(f"recredit: removal arrays {tuple(req.shape)}, {tuple(zmem.shape)}, {tuple(hmem.shape)} "
                         f"do not match K={K}, R={R}, G={G}")
    if counts_host.shape != (G, N) or slot_zoneset.shape != (N, D) or t.group_dom_key.shape != (G,):
        raise ValueError("recredit: carry axes disagree")
    b, f, i = torch.bool, torch.float32, torch.int32
    args = [
        build.require(slot_idx, dev, i, "slot_idx"),
        build.require(req, dev, f, "req"),
        build.require(zmem, dev, b, "zmem"),
        build.require(hmem, dev, b, "hmem"),
        build.require(slot_zoneset, dev, b, "slot_zoneset"),
        build.require(t.group_dom_key, dev, i, "group_dom_key"),
        build.require(t.dom_key_of, dev, i, "dom_key_of"),
        build.require(slot_rem, dev, f, "slot_rem"),
        build.require(counts_host, dev, i, "counts_host"),
        build.require(counts_zone, dev, i, "counts_zone"),
    ]
    rem = torch.empty_like(slot_rem)
    host = torch.empty_like(counts_host)
    zone = torch.empty_like(counts_zone)
    rc = build.lib().kt_recredit(*[a.data_ptr() for a in args], K, N, R, G, D, rem.data_ptr(), host.data_ptr(),
                                 zone.data_ptr(), build.stream_ptr(dev))
    build.check(rc, "recredit")
    build.LAUNCHES["recredit"] += 1
    return (slot_basis, rem, slot_zoneset, slot_rank, zone, host, open_count, ports)
