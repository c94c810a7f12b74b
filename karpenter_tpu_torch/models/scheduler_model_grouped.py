"""Signature-grouped pack: a scan over unique pod shapes, not pods.

Counterpart of the reference's `models/scheduler_model_grouped.py` on the
single-device full-pack path. Each work item is one pod signature with a
replica count; one scan step places all its replicas:

- first-fit over open slots is an exclusive prefix sum:
  take_j = clip(c - sum of capacity before j, 0, cap_j);
- leftover replicas open ceil(left / per-node capacity) fresh slots of the
  best template row at once;
- zone-spread items water-fill over feasible domains (`_waterfill`, or the
  joint `_waterfill_multi` for members of several keyed groups), then fill
  per domain.

`_pack_body` is the plain PyTorch version of the scan (kernel K2,
`kernels/pack_scan.py`); `_flat_outputs` the plain version of the ordered
sparsify (kernel K3, `kernels/sparsify.py`). `greedy_pack_grouped_compressed`
runs the kernels on CUDA tensors and the plain versions on CPU tensors;
`greedy_pack_delta_compressed` runs them over only a delta's items from a
prior pack's carry, and `recredit_removals` (kernel K4,
`kernels/recredit.py`) takes removed pods back out of that carry.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops.bitset import as_int32_words
from ..solver.encoded import (
    KIND_DOM_AFF,
    KIND_DOM_ANTI,
    KIND_DOM_SPREAD,
    KIND_HOST_AFF,
    KIND_HOST_ANTI,
    KIND_HOST_SPREAD,
)
from .scheduler_model import (
    EXIST_BUCKET,
    GROUP_BUCKET,
    INF_I,
    KEYS_BUCKET,
    NEG,
    PORT_BUCKET,
    RES_BUCKET,
    TAINT_BUCKET,
    WORDS_BUCKET,
    SchedulerTensors,
    _pad_axis,
    bucket_hw,
    cap_hw,
    compat_matrix,
    pad_mask_axes,
    perkey_dom_ok,
    row_choose_key,
    spread_ok_of,
)

BIGF = 3.4e38  # f32 "no bound" sentinel

ITEM_AXIS_BUCKET = 64  # full-solve item axis bucket


@dataclass
class ItemTensors:
    """One work item per unique pod signature (device tensors)."""

    item_req: torch.Tensor  # [W, R] f32
    item_mask: torch.Tensor  # [W, K, Words] i32 words
    item_taint_ok: torch.Tensor  # [W, C] bool
    item_dom_allowed: torch.Tensor  # [W, D] bool
    item_restrict: torch.Tensor  # [W, Kd] bool
    item_member: torch.Tensor  # [W, G] bool
    item_owner: torch.Tensor  # [W, G] bool
    item_count: torch.Tensor  # [W] i32
    item_port_any: torch.Tensor  # [W, P1] bool
    item_port_wild: torch.Tensor  # [W, P1] bool
    item_port_spec: torch.Tensor  # [W, P2] bool
    item_host_blocked: torch.Tensor  # [W, max(n_existing, 1)] bool


# Why a multi-group pod shape stayed a count=1 item (bounded value set).
DEMOTION_REASONS = (
    "multi-key",  # member dom groups span >1 domain key; the scan commits one k* per step
    "aff-pin-conflict",  # >=2 required dom-affinity groups may pin conflicting single domains
    "hatch-off",  # KARPENTER_SOLVER_MULTIGROUP=0: per-pod keys for every multi-group shape
)


def demotion_label(reason) -> str:
    """A demotion reason in the bounded DEMOTION_REASONS vocabulary ("other"
    for anything else): the metric label."""
    return reason if reason in DEMOTION_REASONS else "other"


def multigroup_enabled() -> bool:
    """The `KARPENTER_SOLVER_MULTIGROUP` switch (default on)."""
    return os.environ.get("KARPENTER_SOLVER_MULTIGROUP", "1") not in ("0", "false", "no")


def sig_demotions(p):
    """Per-signature demotion: (demote [S] bool, reason index [S] i32)."""
    S = p.n_sigs
    G = p.sig_member.shape[1] if p.sig_member.size else 0
    if not S or not G:
        return np.zeros(max(S, 1), bool), np.zeros(max(S, 1), np.int32)
    kinds = np.asarray(p.group_kind)
    zone_groups = (kinds == KIND_DOM_SPREAD) | (kinds == KIND_DOM_ANTI) | (kinds == KIND_DOM_AFF)
    zone_member = p.sig_member & zone_groups[None, :]
    multi_zone = zone_member.sum(axis=1) > 1
    dom_key = np.asarray(p.group_dom_key)
    keys_lo = np.where(zone_member, dom_key[None, :], 2**30).min(axis=1)
    keys_hi = np.where(zone_member, dom_key[None, :], -1).max(axis=1)
    multi_key = multi_zone & (keys_lo != keys_hi)
    aff_conflict = (p.sig_member & (kinds == KIND_DOM_AFF)[None, :]).sum(axis=1) > 1
    if multigroup_enabled():
        demote = multi_zone & (multi_key | aff_conflict)
        reason = np.where(multi_key, 0, 1).astype(np.int32)
    else:
        demote = multi_zone
        reason = np.where(multi_key, 0, np.where(aff_conflict, 1, 2)).astype(np.int32)
    return demote, reason


def build_items(p, with_info: bool = False):
    """Group pods into work items by signature (demoted shapes get one item
    per pod), in first-appearance order. Returns (item arrays as numpy, pod
    indices per item[, stats dict])."""
    P = p.n_pods
    S = p.n_sigs
    G = p.sig_member.shape[1] if p.sig_member.size else 0
    sig_member = p.sig_member if G else np.zeros((max(S, 1), 1), bool)
    demote_sig, reason_sig = sig_demotions(p)
    sig = np.asarray(p.sig_of_pod, dtype=np.int64)
    key = np.where(demote_sig[sig] if S else False, S + np.arange(P, dtype=np.int64), sig)
    _, first_idx, inverse, counts = np.unique(key, return_index=True, return_inverse=True, return_counts=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    item_of_pod = rank[inverse]
    reps = first_idx[order]
    rep_sig = sig[reps]
    by_item = np.argsort(item_of_pod, kind="stable")
    boundaries = np.cumsum(counts[order])[:-1]
    item_pods = np.split(by_item, boundaries)
    arrays = dict(
        item_req=p.sig_req[rep_sig],
        item_mask=p.sig_mask[rep_sig],
        item_taint_ok=p.sig_taint_ok[rep_sig],
        item_dom_allowed=p.sig_dom_allowed[rep_sig],
        item_restrict=p.sig_restrict[rep_sig],
        item_member=sig_member[rep_sig],
        item_owner=(p.sig_owner if G else np.zeros((max(S, 1), 1), bool))[rep_sig],
        item_count=counts[order].astype(np.int32),
        item_port_any=p.sig_port_any[rep_sig],
        item_port_wild=p.sig_port_wild[rep_sig],
        item_port_spec=p.sig_port_spec[rep_sig],
        item_host_blocked=p.sig_host_blocked[rep_sig],
    )
    arrays = pad_item_arrays(arrays, ITEM_AXIS_BUCKET, item_axis="items")
    item_pods += [np.zeros(0, np.int64)] * (len(arrays["item_count"]) - len(item_pods))
    if not with_info:
        return arrays, item_pods
    demoted_pods = demote_sig[sig] if S else np.zeros(0, bool)
    by_reason = (
        np.bincount(reason_sig[sig[demoted_pods]], minlength=len(DEMOTION_REASONS))
        if P
        else np.zeros(len(DEMOTION_REASONS), np.int64)
    )
    info = dict(
        n_pods=int(P),
        n_items=int(len(reps)),
        demotions={DEMOTION_REASONS[r]: int(by_reason[r]) for r in range(len(DEMOTION_REASONS)) if by_reason[r]},
        multigroup=multigroup_enabled(),
    )
    return arrays, item_pods, info


def item_pad_targets(t: SchedulerTensors, items: ItemTensors) -> dict:
    """Per-axis pad targets matching existing tensors (for item arrays that
    must line up with an already-built pack)."""
    return dict(
        res=int(t.row_alloc.shape[1]),
        keys=int(items.item_mask.shape[1]),
        words=int(items.item_mask.shape[2]),
        taints=int(items.item_taint_ok.shape[1]),
        groups=int(t.group_kind.shape[0]),
        ports1=int(t.row_port_any.shape[1]),
        ports2=int(t.row_port_spec.shape[1]),
        exist=int(t.existing_domset.shape[0]),
    )


def pad_item_arrays(arrays: dict, item_bucket: int, item_axis: str = "delta_items", targets: dict | None = None) -> dict:
    """Pad item arrays to the same axis buckets make_tensors uses, plus the
    item axis itself; pad items have count 0 and allow nothing."""
    a = dict(arrays)
    tg = targets if targets is not None else {
        "res": bucket_hw("res", a["item_req"].shape[1], RES_BUCKET),
        "keys": bucket_hw("keys", a["item_mask"].shape[1], KEYS_BUCKET),
        "words": bucket_hw("words", a["item_mask"].shape[2], WORDS_BUCKET),
        "taints": bucket_hw("taints", a["item_taint_ok"].shape[1], TAINT_BUCKET),
        "groups": bucket_hw("groups", a["item_member"].shape[1], GROUP_BUCKET),
        "ports1": bucket_hw("ports1", a["item_port_any"].shape[1], PORT_BUCKET),
        "ports2": bucket_hw("ports2", a["item_port_spec"].shape[1], PORT_BUCKET),
        "exist": bucket_hw("exist", a["item_host_blocked"].shape[1], EXIST_BUCKET),
    }
    a["item_req"] = _pad_axis(a["item_req"], 1, tg["res"])
    a["item_mask"] = pad_mask_axes(a["item_mask"], tg["keys"], tg["words"])
    a["item_taint_ok"] = _pad_axis(a["item_taint_ok"], 1, tg["taints"], fill=True)
    for name, axis in (("item_member", "groups"), ("item_owner", "groups"), ("item_port_any", "ports1"),
                       ("item_port_wild", "ports1"), ("item_port_spec", "ports2"), ("item_host_blocked", "exist")):
        a[name] = _pad_axis(a[name], 1, tg[axis], fill=False)
    W_p = bucket_hw(item_axis, a["item_count"].shape[0], item_bucket)
    for k in a:
        a[k] = _pad_axis(a[k], 0, W_p, fill=0 if a[k].dtype != bool else False)
    return a


def make_item_tensors(arrays: dict, device) -> ItemTensors:
    """Item arrays (numpy) -> ItemTensors on `device`; mask words become
    int32 with the same bits."""
    dtypes = {"item_req": torch.float32, "item_mask": torch.int32, "item_count": torch.int32}
    out = {}
    for f in fields(ItemTensors):
        a = arrays[f.name]
        if f.name == "item_mask":
            a = as_int32_words(a)
        out[f.name] = torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtypes.get(f.name, torch.bool))
    return ItemTensors(**out)


# -- integer capacities and water-fills ----------------------------------------


def _int_cap(rem, req):
    """[..., R] remaining -> [...] integer pod capacity: min over requested
    resources of floor(rem / req), clipped to [0, 2**30]."""
    safe = torch.where(req > 0, torch.floor(rem / torch.clamp_min(req, 1e-9)), BIGF)
    return torch.clamp(safe.amin(dim=-1), 0, 2**30).to(torch.int32)


_int_cap_nd = _int_cap  # [..., D, R] -> [..., D]: the same broadcast


def _i32(x) -> torch.Tensor:
    """Sum/cumsum results back to int32 (the reference's x64-off wraparound)."""
    return x.to(torch.int32)


def _waterfill(v, finite, c, cap):
    """Integer water-fill: distribute c among finite entries, repeatedly
    raising the current minimum (ties to the lowest index), never exceeding
    cap[z]. Exactly 2Z+2 rounds, then the remainder to the lowest-index
    minimum entries. Returns inc[Z] i32."""
    Z = v.shape[0]
    vf = torch.where(finite, v.to(torch.float32), BIGF)
    capf = torch.clamp(cap, 0, 2**30).to(torch.int32)
    inc = torch.zeros(Z, dtype=torch.int32, device=v.device)
    rem = c.to(torch.int32)
    for _ in range(2 * Z + 2):
        active = finite & (inc < capf)
        cur = torch.where(active, vf + inc.to(torch.float32), BIGF)
        m = cur.amin()
        is_min = (cur == m) & active
        kmin = _i32(is_min.sum())
        nxt = torch.where(cur > m, cur, BIGF).amin()
        gap = torch.where(nxt < BIGF / 2, nxt - m, BIGF)
        headroom = torch.where(is_min, capf - inc, INF_I).amin()
        quota = torch.floor(rem.to(torch.float32) / torch.clamp_min(kmin, 1).to(torch.float32))
        d = torch.minimum(torch.minimum(gap, headroom.to(torch.float32)), quota).to(torch.int32)
        d = torch.where(kmin > 0, torch.clamp_min(d, 0), 0)
        inc = inc + torch.where(is_min, d, 0)
        rem = rem - d * kmin
    active = finite & (inc < capf)
    cur = torch.where(active, vf + inc.to(torch.float32), BIGF)
    is_min = (cur == cur.amin()) & active
    pos = _i32(torch.cumsum(is_min.to(torch.int32), 0)) - 1
    inc = inc + torch.where(is_min & (pos < rem), 1, 0).to(torch.int32)
    return torch.where(finite, inc, 0)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _waterfill_multi(counts_g, member, skew_g, reg_g, min_domains_g, za, avail, c):
    """Joint multi-group integer water-fill: distribute c pods that are
    members of several keyed spread groups, reproducing c sequential
    per-pod placements (argmin of the summed member level, ties to the
    lowest index, among domains where every member group's skew check
    passes) in chunked laps; a round that could let a capped domain re-enter
    mid-lap, or with fewer pods than minimum domains, places one pod."""
    D = counts_g.shape[1]
    dev = counts_g.device
    sel = member.unsqueeze(1)  # [G, 1]
    regm = reg_g & za.unsqueeze(0)
    m = torch.clamp_min(_i32(member.sum()), 1)
    supported = _i32(regm.sum(dim=1))
    force_zero = (min_domains_g > 0) & (supported < min_domains_g)
    idx = torch.arange(D, dtype=torch.int32, device=dev)
    inc = torch.zeros(D, dtype=torch.int32, device=dev)
    rem = c.to(torch.int32)
    while int(rem) > 0:
        cg = counts_g + torch.where(sel, inc.unsqueeze(0), 0)
        zmin = torch.where(regm, cg, INF_I).amin(dim=1)
        zmin = torch.where(zmin >= INF_I, 0, zmin)
        zmin = torch.where(force_zero, 0, zmin)
        ok_g = ((cg + 1 - zmin.unsqueeze(1)) <= skew_g.unsqueeze(1)) & reg_g
        ok = torch.where(sel, ok_g, True).all(dim=0)
        lvl = _i32(torch.where(sel, cg, 0).sum(dim=0))
        active = avail & ok
        cur = torch.where(active, lvl, INF_I)
        mlvl = cur.amin()
        is_min = active & (cur == mlvl)
        kmin = _i32(is_min.sum())
        if int(kmin) == 0:
            break
        nxt = torch.where(active & (cur > mlvl), cur, INF_I).amin()
        d_gap = torch.where(nxt < INF_I, -_floordiv(-(nxt - mlvl), m), INF_I)
        p_g = torch.where(regm & is_min.unsqueeze(0), cg, INF_I).amin(dim=1)
        u_g = torch.where(regm & ~is_min.unsqueeze(0), cg, INF_I).amin(dim=1)
        u_g = torch.where(force_zero, 0, u_g)
        dcap_gz = torch.where((u_g < INF_I).unsqueeze(1), skew_g.unsqueeze(1) + u_g.unsqueeze(1) - cg, INF_I)
        d_head = torch.where(sel & is_min.unsqueeze(0), dcap_gz, INF_I).amin()
        thr = cg + 1 - skew_g.unsqueeze(1)
        k_g = torch.where(
            (u_g.unsqueeze(1) >= thr) & (p_g < INF_I).unsqueeze(1) & ~force_zero.unsqueeze(1),
            torch.clamp_min(thr - p_g.unsqueeze(1), 1),
            INF_I,
        )
        blocking = sel & ~ok_g & reg_g
        react = torch.where(blocking, k_g, 0).amax(dim=0)
        react = torch.where((blocking & (k_g >= INF_I)).any(dim=0), INF_I, react)
        reg_all = torch.where(sel, reg_g, True).all(dim=0)
        rejoinable = avail & ~ok & reg_all
        react_c = torch.clamp_max(react, 2**20)
        mid_capture = lvl < torch.clamp_max(mlvl, 2**20) + (react_c - 1) * m
        safe_lap = torch.where(react >= INF_I, INF_I, torch.where(mid_capture, react - 1, react))
        d_react = torch.where(rejoinable, safe_lap, INF_I).amin()
        partial = (rem < kmin) | (d_react < 1)
        d = torch.minimum(torch.minimum(d_gap, d_head), torch.minimum(d_react, _floordiv(rem, torch.clamp_min(kmin, 1))))
        d = torch.clamp_min(d, 1)
        first = torch.argmin(torch.where(is_min, idx, INF_I)).to(torch.int32)
        pour = torch.where(partial, torch.where(is_min & (idx == first), 1, 0), torch.where(is_min, d, 0)).to(torch.int32)
        inc = inc + pour
        rem = rem - _i32(pour.sum())
    return inc


# -- the pack scan (plain version of kernel K2) ----------------------------------


def initial_state(t: SchedulerTensors, n_slots: int):
    """The scan's starting carry: slots below n_existing hold the existing
    nodes' envelopes, domain sets and ports; the rest are closed.
    (slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host,
    open_count, (port_any, port_wild, port_spec))."""
    dev = t.device
    Nrows = t.row_alloc.shape[0]
    slot_ids = torch.arange(n_slots, dtype=torch.int32, device=dev)
    in_ex = slot_ids < t.n_existing
    safe_row = torch.clamp(slot_ids, 0, Nrows - 1).to(torch.int64)
    safe_ex = torch.clamp(slot_ids, 0, t.existing_domset.shape[0] - 1).to(torch.int64)
    col = in_ex.unsqueeze(1)
    return (
        torch.where(in_ex, slot_ids, -1).to(torch.int32),
        torch.where(col, t.row_alloc[safe_row], NEG).to(torch.float32),
        torch.where(col, t.existing_domset[safe_ex], False),
        torch.full((n_slots,), -1, dtype=torch.int32, device=dev),
        t.counts_dom_init.clone(),
        t.counts_host_init.clone(),
        torch.tensor(t.n_existing, dtype=torch.int32, device=dev),
        (
            torch.where(col, t.existing_port_any[safe_ex], False),
            torch.where(col, t.existing_port_wild[safe_ex], False),
            torch.where(col, t.existing_port_spec[safe_ex], False),
        ),
    )


def _pack_body(t: SchedulerTensors, items: ItemTensors, *, n_slots: int, init_state=None, precomputed=None):
    """Plain PyTorch version of the grouped pack scan (single device).

    Walks the W items in order; each step dispatches one of five paths
    (simple / zone / anti / dom-affinity / host-affinity), every path placing
    replicas through `place`. Returns (takes [W, N] i32, leftovers [W] i32,
    final carry) — the carry in `initial_state`'s layout."""
    dev = t.device
    W, R = items.item_req.shape
    N = n_slots
    Nrows = t.row_alloc.shape[0]
    G, D = t.counts_dom_init.shape
    Kd = items.item_restrict.shape[1]
    Q = t.rank_domset.shape[0]
    n_existing = t.n_existing
    slot_ids = torch.arange(N, dtype=torch.int32, device=dev)
    in_existing = slot_ids < n_existing
    row_ids = torch.arange(Nrows, dtype=torch.int32, device=dev)
    is_offering_row = (row_ids >= n_existing) & (row_ids < t.n_rows_real)
    rank_of_row = torch.clamp(t.row_pool_rank, 0, Q - 1).to(torch.int64)
    kind = t.group_kind
    is_dom_spread_g = kind == KIND_DOM_SPREAD
    is_dom_anti_g = kind == KIND_DOM_ANTI
    is_dom_aff_g = kind == KIND_DOM_AFF
    is_host_aff_g = kind == KIND_HOST_AFF
    host_gate_kinds = (kind == KIND_HOST_SPREAD) | (kind == KIND_HOST_ANTI)
    host_count_kinds = host_gate_kinds | is_host_aff_g
    hb_width = items.item_host_blocked.shape[1]
    hb_idx = torch.clamp(slot_ids, 0, hb_width - 1).to(torch.int64)
    kd_ids = torch.arange(Kd, device=dev)
    d_ids = torch.arange(D, device=dev)

    if precomputed is not None:
        compat_items, choose_key_items = precomputed
    else:
        compat_items = compat_matrix(t.row_labels, t.row_taint_class, items.item_mask, items.item_taint_ok, t.dom_keys)
        choose_key_items = row_choose_key(t.row_alloc, t.row_pool_rank, items.item_req)

    state = init_state if init_state is not None else initial_state(t, N)
    takes = torch.zeros((W, N), dtype=torch.int32, device=dev)
    leftovers = torch.zeros(W, dtype=torch.int32, device=dev)

    for i in range(W):
        slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports = state
        req = items.item_req[i]
        za = items.item_dom_allowed[i]
        restrict = items.item_restrict[i]
        mem = items.item_member[i]
        own = items.item_owner[i]
        c = items.item_count[i]
        compat_rows = compat_items[i]
        choose_key = choose_key_items[i]
        pany = items.item_port_any[i]
        pwild = items.item_port_wild[i]
        pspec = items.item_port_spec[i]
        port_cap = 1 if bool(pany.any()) else INF_I

        def port_ok_of(ports_now):
            s_any, s_wild, s_spec = ports_now
            conflict = (s_any & pwild).any(dim=1) | (s_wild & pany).any(dim=1) | (s_spec & pspec).any(dim=1)
            return ~conflict

        zone_member_mask = mem & (is_dom_spread_g | is_dom_anti_g | is_dom_aff_g)
        is_zm = bool(zone_member_mask.any())
        k_star = torch.where(zone_member_mask, t.group_dom_key, -1).amax()
        kmask = t.dom_key_of == k_star
        restrict_other = restrict & (kd_ids != k_star)
        host_member_mask = mem & host_count_kinds
        host_owner_mask = own & host_gate_kinds
        blocked_slots = in_existing & items.item_host_blocked[i][hb_idx]

        def member_host_cap(counts_host_now):
            cap_from_group = torch.where(
                (kind == KIND_HOST_SPREAD).unsqueeze(1),
                t.group_skew.unsqueeze(1) - counts_host_now,
                torch.where((kind == KIND_HOST_ANTI).unsqueeze(1), (counts_host_now == 0).to(torch.int32), INF_I),
            )
            return torch.where(host_owner_mask.unsqueeze(1), cap_from_group, INF_I).amin(dim=0)

        host_cap_new = torch.where(
            host_owner_mask,
            torch.where(kind == KIND_HOST_SPREAD, t.group_skew, torch.where(kind == KIND_HOST_ANTI, 1, INF_I)),
            INF_I,
        ).amin()

        def slot_compat_of(slot_basis_now):
            rows = torch.clamp(slot_basis_now, 0, Nrows - 1).to(torch.int64)
            return (slot_basis_now >= 0) & compat_rows[rows] & ~blocked_slots

        fits_row = is_offering_row & compat_rows & (req.unsqueeze(0) <= t.row_alloc).all(dim=1)
        row_port_conflict = (
            (t.row_port_any & pwild).any(dim=1) | (t.row_port_wild & pany).any(dim=1) | (t.row_port_spec & pspec).any(dim=1)
        )
        fits_row = fits_row & ~row_port_conflict
        row_cap = _int_cap(t.row_alloc, req)
        spread_ok = spread_ok_of(t, za, zone_member_mask, counts_zone)
        rank_ok_all = perkey_dom_ok(t.rank_domset, za, restrict, t.dom_key_of)
        rank_ok_other = perkey_dom_ok(t.rank_domset, za, restrict_other, t.dom_key_of)
        open_cap_d = _int_cap_nd(t.rank_dom_cap, req)  # [Q, D]
        rank_fits_d = open_cap_d >= 1
        openable_z = ((fits_row & rank_ok_other[rank_of_row]).unsqueeze(1) & (t.rank_domset & rank_fits_d)[rank_of_row]).any(dim=0)

        def place(cnt, elig_mask, rank_ok, narrow, st):
            """Place `cnt` identical pods: prefix-sum first-fit over eligible
            slots, then open fresh slots of the best row for the leftover;
            `narrow` is intersected into touched slots' domain sets."""
            slot_rem, slot_zoneset, slot_basis, slot_rank, counts_host, open_count, ports = st
            cap_res = _int_cap(slot_rem, req)
            basis_rows = torch.clamp(slot_basis, 0, Nrows - 1).to(torch.int64)
            total = t.row_alloc[basis_rows] - slot_rem
            rem_nd = t.rank_dom_cap[torch.clamp(slot_rank, 0, Q - 1).to(torch.int64)] - total.unsqueeze(1)
            cap_nd = _int_cap_nd(rem_nd, req)
            target = slot_zoneset & narrow
            cap_dom = torch.where(target, cap_nd, 0).amax(dim=1)
            cap_dom = torch.where(slot_rank < 0, INF_I, cap_dom)
            cap_j = torch.where(
                elig_mask & port_ok_of(ports),
                torch.clamp_max(torch.minimum(torch.minimum(cap_res, cap_dom), member_host_cap(counts_host)), port_cap),
                0,
            )
            cap_j = torch.clamp(cap_j, 0, INF_I)
            prefix = _i32(torch.cumsum(cap_j, 0, dtype=torch.int64) - cap_j)
            take = torch.minimum(torch.clamp_min(cnt - prefix, 0), cap_j).to(torch.int32)
            left = cnt - _i32(take.sum())

            rank_cap_ok = (t.rank_domset & narrow & rank_fits_d).any(dim=1)
            fr = fits_row & (rank_ok & rank_cap_ok)[rank_of_row]
            o = int(torch.argmin(torch.where(fr, choose_key, BIGF)))
            o_ok = bool(fr[o])
            ro = int(rank_of_row[o])
            cap_open = torch.where(t.rank_domset[ro] & narrow, open_cap_d[ro], 0).amax()
            cstar = torch.clamp_max(torch.minimum(torch.minimum(row_cap[o], cap_open), host_cap_new), port_cap)
            can_open = o_ok and bool(cstar >= 1)
            m = -_floordiv(-left, torch.clamp_min(cstar, 1)) if can_open else torch.zeros((), dtype=torch.int32, device=dev)
            m = torch.minimum(torch.clamp_min(m, 0), N - open_count)
            is_new = (slot_ids >= open_count) & (slot_ids < open_count + m)
            pos = slot_ids - open_count
            new_take = torch.where(is_new, torch.minimum(torch.clamp_min(left - pos * cstar, 0), cstar), 0).to(torch.int32)
            left = left - _i32(new_take.sum())

            new_zs = t.rank_domset[ro] & narrow
            col = is_new.unsqueeze(1)
            slot_basis = torch.where(is_new, o, slot_basis).to(torch.int32)
            slot_rank = torch.where(is_new, t.row_pool_rank[o], slot_rank)
            slot_rem = torch.where(col, t.row_alloc[o].unsqueeze(0), slot_rem)
            slot_zoneset = torch.where(col, new_zs.unsqueeze(0), slot_zoneset)
            open_count = (open_count + m).to(torch.int32)

            take = take + new_take
            touched = (take > 0).unsqueeze(1)
            slot_zoneset = torch.where(touched, slot_zoneset & narrow, slot_zoneset)
            slot_rem = slot_rem - take.unsqueeze(1).to(torch.float32) * req
            counts_host = counts_host + torch.where(host_member_mask.unsqueeze(1), take.unsqueeze(0), 0)
            s_any, s_wild, s_spec = ports
            s_any = torch.where(col, t.row_port_any[o].unsqueeze(0), s_any)
            s_wild = torch.where(col, t.row_port_wild[o].unsqueeze(0), s_wild)
            s_spec = torch.where(col, t.row_port_spec[o].unsqueeze(0), s_spec)
            ports = (torch.where(touched, s_any | pany, s_any), torch.where(touched, s_wild | pwild, s_wild),
                     torch.where(touched, s_spec | pspec, s_spec))
            return take, left, (slot_rem, slot_zoneset, slot_basis, slot_rank, counts_host, open_count, ports)

        def other_ok_of(zs_now):
            return perkey_dom_ok(zs_now, za, restrict_other, t.dom_key_of)

        def narrow_of(z):
            return torch.where(kmask, d_ids == z, za)

        def zone_elig(st, z):
            return slot_compat_of(st[2]) & st[1][:, z] & other_ok_of(st[1])

        st = (slot_rem, slot_zoneset, slot_basis, slot_rank, counts_host, open_count, ports)
        is_anti_item = bool((zone_member_mask & is_dom_anti_g).any())
        is_domaff_item = bool((zone_member_mask & is_dom_aff_g).any())
        is_hostaff_item = bool((mem & is_host_aff_g).any())

        if is_hostaff_item:
            aff_g = own & is_host_aff_g

            def rec_ok_of(counts_host_now):
                return torch.where(aff_g.unsqueeze(1), counts_host_now > 0, True).all(dim=0)

            def dom_ok_of(zs_now):
                return perkey_dom_ok(zs_now, za, restrict, t.dom_key_of)

            any_rec = bool(rec_ok_of(st[4]).any())
            boot_cnt = torch.zeros_like(c) if any_rec else torch.clamp_max(c, 1)
            take1, left1, st = place(boot_cnt, slot_compat_of(st[2]) & dom_ok_of(st[1]), rank_ok_all, za, st)
            rest = c - (boot_cnt - left1)
            no_open = torch.zeros(Q, dtype=torch.bool, device=dev)
            take2, left2, st = place(rest, slot_compat_of(st[2]) & dom_ok_of(st[1]) & rec_ok_of(st[4]), no_open, za, st)
            take_all, pending = take1 + take2, left2
        elif is_domaff_item:
            aff_mask = zone_member_mask & is_dom_aff_g
            vsum = _i32(torch.where(aff_mask.unsqueeze(1), counts_zone, 0).sum(dim=0))
            reg_star = torch.where(aff_mask.unsqueeze(1), t.group_registered, False).any(dim=0)
            allowed_rec = za & kmask & reg_star & (vsum > 0)
            any_rec = bool(allowed_rec.any())
            bootstrapable = za & kmask & reg_star
            take_all = torch.zeros(N, dtype=torch.int32, device=dev)
            pending = c
            placed_z = torch.zeros(D, dtype=torch.int32, device=dev)
            boot = -1
            for z in range(D):
                active = bool(allowed_rec[z]) if any_rec else (boot == z if boot >= 0 else bool(bootstrapable[z]))
                cnt = pending if active else torch.zeros_like(pending)
                take, left, st = place(cnt, zone_elig(st, z), t.rank_domset[:, z] & rank_ok_other, narrow_of(z), st)
                placed = cnt - left
                take_all = take_all + take
                pending = pending - placed
                placed_z[z] += placed
                if not any_rec and boot < 0 and int(placed) > 0:
                    boot = z
            counts_zone = counts_zone + torch.where(aff_mask.unsqueeze(1), placed_z.unsqueeze(0), 0)
        elif is_anti_item:
            reg_star = torch.where(zone_member_mask.unsqueeze(1), t.group_registered, False).any(dim=0)
            take_all = torch.zeros(N, dtype=torch.int32, device=dev)
            pending = c
            for _ in range(D + 1):
                vsum = _i32(torch.where(zone_member_mask.unsqueeze(1), counts_zone, 0).sum(dim=0))
                empty = reg_star & (vsum == 0) & za & kmask
                narrow = torch.where(kmask, empty, za)
                elig = slot_compat_of(st[2]) & other_ok_of(st[1]) & (st[1] & empty).any(dim=1)
                row_gate = (t.rank_domset & empty).any(dim=1) & rank_ok_other
                cnt = torch.clamp_max(pending, 1)
                take, left, st = place(cnt, elig, row_gate, narrow, st)
                blocked = ((take > 0).unsqueeze(1) & st[1]).any(dim=0) & kmask
                counts_zone = counts_zone + torch.where(zone_member_mask.unsqueeze(1), blocked.to(torch.int32).unsqueeze(0), 0)
                take_all = take_all + take
                pending = pending - (cnt - left)
        elif is_zm:
            slotcap_z = (
                (slot_compat_of(st[2]) & (_int_cap(st[0], req) > 0) & port_ok_of(st[6]) & other_ok_of(st[1])).unsqueeze(1)
                & st[1]
            ).any(dim=0)
            zm_col = zone_member_mask.unsqueeze(1)
            vsum = _i32(torch.where(zm_col, counts_zone, 0).sum(dim=0))
            skew_star = torch.where(zone_member_mask & is_dom_spread_g, t.group_skew, INF_I).amin()
            reg_star = torch.where(zm_col, t.group_registered, False).any(dim=0)
            allowed_real = za & reg_star & kmask
            available = allowed_real & (openable_z | slotcap_z)
            multi = int(zone_member_mask.sum()) > 1
            finite = available & spread_ok if multi else available
            frozen = allowed_real & ~available
            frozen_min = torch.where(frozen, vsum, INF_I).amin()
            md_star = torch.where(zone_member_mask, t.group_min_domains, 0).amax()
            supported = _i32((za & reg_star & kmask).sum())
            force_zero = bool((md_star > 0) & (supported < md_star))
            if force_zero:
                frozen_min = torch.zeros_like(frozen_min)
            cap = torch.clamp(frozen_min + skew_star - vsum, 0, INF_I)
            if multi:
                inc = _waterfill_multi(counts_zone, zone_member_mask, t.group_skew, t.group_registered,
                                       t.group_min_domains, za, available, c)
            else:
                inc = _waterfill(vsum, finite, c, cap)
            reg_all_members = torch.where(zm_col, t.group_registered, True).all(dim=0)

            def multi_headroom(placed):
                cg_u = counts_zone + torch.where(zm_col, placed.unsqueeze(0), 0)
                zr = za.unsqueeze(0) & t.group_registered
                zmin_g = torch.where(zr, cg_u, INF_I).amin(dim=1)
                zmin_g = torch.where(zmin_g >= INF_I, 0, zmin_g)
                sup_g = _i32(zr.sum(dim=1))
                zmin_g = torch.where((t.group_min_domains > 0) & (sup_g < t.group_min_domains), 0, zmin_g)
                head_g = zmin_g.unsqueeze(1) + t.group_skew.unsqueeze(1) - cg_u
                head = torch.where(zm_col, head_g, INF_I).amin(dim=0)
                return torch.clamp(torch.where(reg_all_members & available, head, 0), 0, INF_I)

            take_all = torch.zeros(N, dtype=torch.int32, device=dev)
            pending = c - _i32(inc.sum())
            placed_z = torch.zeros(D, dtype=torch.int32, device=dev)
            for z in range(D):
                cz = inc[z]
                take, left, st = place(cz, zone_elig(st, z), t.rank_domset[:, z] & rank_ok_other, narrow_of(z), st)
                take_all = take_all + take
                pending = pending + left
                placed_z[z] = cz - left
            for z in range(D):
                vsum_u = vsum + placed_z
                zmin_u = torch.where(allowed_real, vsum_u, INF_I).amin()
                zmin_u = torch.where(zmin_u >= INF_I, 0, zmin_u)
                if force_zero:
                    zmin_u = torch.zeros_like(zmin_u)
                if multi:
                    headroom = multi_headroom(placed_z)[z]
                else:
                    headroom = torch.clamp(zmin_u + skew_star - vsum_u[z], 0, INF_I) if bool(finite[z]) else torch.zeros_like(zmin_u)
                cz = torch.minimum(pending, headroom)
                take, left, st = place(cz, zone_elig(st, z), t.rank_domset[:, z] & rank_ok_other, narrow_of(z), st)
                take_all = take_all + take
                pending = pending - (cz - left)
                placed_z[z] += cz - left
            counts_zone = counts_zone + torch.where(zm_col, placed_z.unsqueeze(0), 0)
        else:
            elig = slot_compat_of(st[2]) & perkey_dom_ok(st[1], za, restrict, t.dom_key_of)
            take_all, pending, st = place(c, elig, rank_ok_all, za, st)

        slot_rem, slot_zoneset, slot_basis, slot_rank, counts_host, open_count, ports = st
        state = (slot_basis, slot_rem, slot_zoneset, slot_rank, counts_zone, counts_host, open_count, ports)
        takes[i] = take_all
        leftovers[i] = pending
    return takes, leftovers, state


# -- ordered sparsify (plain version of kernel K3) --------------------------------


def _sparsify_takes(takes, nnz_cap: int):
    """[W, N] takes -> row-major (item, slot, count) triples, -1-padded (count
    0) to nnz_cap; nonzeros past nnz_cap are dropped."""
    W, N = takes.shape
    nzi, nzs = torch.nonzero(takes, as_tuple=True)
    nnz = min(int(nzi.shape[0]), nnz_cap)
    out_i = torch.full((nnz_cap,), -1, dtype=torch.int32, device=takes.device)
    out_s = torch.full((nnz_cap,), -1, dtype=torch.int32, device=takes.device)
    out_c = torch.zeros(nnz_cap, dtype=torch.int32, device=takes.device)
    out_i[:nnz] = nzi[:nnz].to(torch.int32)
    out_s[:nnz] = nzs[:nnz].to(torch.int32)
    out_c[:nnz] = takes[nzi[:nnz], nzs[:nnz]]
    return out_i, out_s, out_c


def _flat_outputs(takes, leftovers, slot_basis, slot_zoneset, open_count, nnz_cap: int):
    """Every host-needed pack output in one int32 vector: triples, basis,
    zoneset (row-major), leftovers, open_count."""
    nzi, nzs, nzc = _sparsify_takes(takes, nnz_cap)
    return torch.cat([
        nzi, nzs, nzc,
        slot_basis.to(torch.int32),
        slot_zoneset.reshape(-1).to(torch.int32),
        leftovers.to(torch.int32),
        open_count.to(torch.int32).reshape(1),
    ])


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _parse_flat(flat: np.ndarray, nnz_cap: int, N: int, Z: int, W: int) -> dict:
    o = 0

    def take(n):
        nonlocal o
        out = flat[o : o + n]
        o += n
        return out

    nz_item, nz_slot, nz_count = take(nnz_cap), take(nnz_cap), take(nnz_cap)
    slot_basis = take(N)
    slot_zoneset = take(N * Z).reshape(N, Z).astype(bool)
    leftovers = take(W)
    open_count = int(take(1)[0])
    return dict(nz_item=nz_item, nz_slot=nz_slot, nz_count=nz_count, slot_basis=slot_basis,
                slot_zoneset=slot_zoneset, leftovers=leftovers, open_count=open_count)


def nnz_cap_for(n_pods: int, W: int, N: int) -> int:
    """Static triple capacity: nnz <= n_pods, rounded up to a power of two
    and held at its high-water mark."""
    return int(min(cap_hw("nnz_full", _next_pow2(n_pods)), W * N))


def _pack_flat(t: SchedulerTensors, items: ItemTensors, nnz_cap: int, init_state=None) -> dict:
    """K1 -> K2 (from `init_state` when given) -> K3, each through its kernel
    wrapper. Returns the parsed outputs (numpy), `flat` (the device vector)
    and `state`, the scan's final carry, left on the device."""
    from ..kernels.feasibility import feasibility
    from ..kernels.pack_scan import pack_scan
    from ..kernels.sparsify import flat_outputs

    W = items.item_req.shape[0]
    N = t.n_slots
    Z = t.counts_dom_init.shape[1]
    compat, key = feasibility(t, items)
    takes, leftovers, state = pack_scan(t, items, compat, key, n_slots=N, init_state=init_state)
    flat = flat_outputs(takes, leftovers, state[0], state[2], state[6], nnz_cap)
    out = _parse_flat(flat.cpu().numpy(), nnz_cap, N, Z, W)
    out.update(flat=flat, state=state, nnz_cap=nnz_cap, n_slots=N)
    return out


def greedy_pack_grouped_compressed(t: SchedulerTensors, items: ItemTensors, n_pods: int, init_state=None) -> dict:
    """Run the pack: feasibility (K1), the scan (K2) and the ordered sparsify
    (K3), each through its kernel wrapper (kernel on CUDA tensors, plain
    version on CPU tensors). Returns the parsed outputs (numpy), `flat`
    (the device vector) and `state`, the scan's final carry, left on the
    device for an incremental re-solve."""
    nnz_cap = nnz_cap_for(n_pods, items.item_req.shape[0], t.n_slots)
    return _pack_flat(t, items, nnz_cap, init_state=init_state)


DELTA_ITEM_BUCKET = 16  # delta item axis pads to this so deltas share one shape
REMOVAL_BUCKET = 16  # removal axis pads to this so removals share one shape


def delta_nnz_cap(n_added: int) -> int:
    """The delta pack's triple capacity: its own high-water mark over
    next_pow2(n_added), not bounded by W x N (the full solve's cap is
    `nnz_cap_for`; the two differ, and with them every offset of the flat
    output)."""
    return int(cap_hw("nnz_delta", _next_pow2(max(n_added, 2))))


def greedy_pack_delta_compressed(state, t: SchedulerTensors, items: ItemTensors, n_added: int) -> dict:
    """Incremental pack over only the delta items, continuing from `state`
    (a prior pack's device-resident final carry): K1 on the delta items
    against the resident tensors, K2 from the carry, K3 with the delta cap.
    Items must be padded to a DELTA_ITEM_BUCKET multiple (pad entries have
    count 0). Same dict as greedy_pack_grouped_compressed; takes and
    leftovers span the (padded) delta items."""
    return _pack_flat(t, items, delta_nnz_cap(n_added), init_state=state)


def recredit_removals(state, t: SchedulerTensors, slot_idx, req, zmem, hmem):
    """Take removed pods back out of a pack carry (kernel K4 through its
    wrapper). slot_idx [K] (numpy, the slot each removed placed pod holds),
    req [K, R] their requests, zmem / hmem [K, G_p] their spread and
    hostname-counted memberships. Pads the removal axis to a REMOVAL_BUCKET
    multiple with slot -1; returns the new carry."""
    from ..kernels.recredit import recredit

    R = int(state[1].shape[1])
    if req.shape[1] != R:
        # the reference's scatter-add cannot broadcast [K, R] into [K, R_p]
        # either: it raises on the same input
        raise ValueError(f"recredit_removals: request width {req.shape[1]} != carry resource axis {R}")
    K = int(slot_idx.shape[0])
    K_pad = bucket_hw("removals", K, REMOVAL_BUCKET)
    if K_pad != K:
        pad = K_pad - K
        slot_idx = np.concatenate([slot_idx, np.full(pad, -1, slot_idx.dtype)])
        req = np.concatenate([req, np.zeros((pad, req.shape[1]), req.dtype)])
        zmem = np.concatenate([zmem, np.zeros((pad, zmem.shape[1]), bool)])
        hmem = np.concatenate([hmem, np.zeros((pad, hmem.shape[1]), bool)])
    dev = state[1].device

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    return recredit(state, t, up(slot_idx, torch.int32), up(req, torch.float32), up(zmem, torch.bool),
                    up(hmem, torch.bool))


def greedy_pack_grouped(t: SchedulerTensors, items: ItemTensors):
    """The pack with the dense take matrix (no sparsify): K1 -> K2 from the
    initial carry. Returns (takes [W, N], leftovers [W], slot_basis,
    slot_zoneset, slot_rank, open_count)."""
    from ..kernels.feasibility import feasibility
    from ..kernels.pack_scan import pack_scan

    compat, key = feasibility(t, items)
    takes, leftovers, state = pack_scan(t, items, compat, key, n_slots=t.n_slots)
    return takes, leftovers, state[0], state[2], state[3], state[6]


def assignment_from_triples(nz_item, nz_slot, nz_count, item_pods, n_pods: int) -> np.ndarray:
    """Spread each item's pods over its placed slots (slot-index order);
    leftover pods stay unassigned (-1)."""
    assignment = np.full(n_pods, -1, dtype=np.int64)
    valid = nz_item >= 0
    items_np = nz_item[valid].astype(np.int64)
    slots_np = nz_slot[valid]
    counts_np = nz_count[valid].astype(np.int64)
    if items_np.size == 0:
        return assignment
    W = len(item_pods)
    expanded = np.repeat(slots_np, counts_np)
    placed_per_item = np.bincount(items_np, weights=counts_np, minlength=W).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(placed_per_item)])
    for w, pod_idxs in enumerate(item_pods):
        k = min(int(placed_per_item[w]), len(pod_idxs))
        if k:
            assignment[np.asarray(pod_idxs)[:k]] = expanded[offs[w] : offs[w] + k]
    return assignment
