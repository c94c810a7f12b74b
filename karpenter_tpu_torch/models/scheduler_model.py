"""Device tensors of the scheduler, the per-step helper functions and the
per-pod pack.

Counterpart of the reference's `models/scheduler_model.py`: the shape-bucket
ladder (with this package's own high-water marks), `make_tensors` (without
the per-pod tensors, so the grouped pack uploads nothing P-sized) and
`make_pod_tensors` (the per-pod half, for the per-pod pack), the plain
versions of `compat_matrix`, `row_choose_key`, `group_feasibility`,
`spread_ok_of` and `perkey_dom_ok`, and the per-pod FFD scan:
`greedy_pack_plain` (the reference's `_greedy_pack_impl` step for step) and
`greedy_pack` (K1 over the pods, then K8 `perpod_pack`).

Slot state carried by the pack (see `scheduler_model_grouped`):
  slot_basis[N]     basis row id backing the capacity envelope (-1 = closed)
  slot_rem[N, R]    basis allocatable minus accumulated requests
  slot_zoneset[N,D] domains the slot can still land in
  slot_rank[N]      template rank (-1 = existing node)
  counts_zone[G,D]  per-group domain counts (keyed spread / anti / affinity)
  counts_host[G,N]  per-group per-slot counts (hostname kinds)
  open_count        number of open slots
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bitset import as_int32_words, test_bit
from ..ops.select import first_true_index, masked_argmin
from ..solver.encoded import KIND_DOM_ANTI, KIND_DOM_SPREAD, KIND_HOST_ANTI, KIND_HOST_SPREAD

NEG = -3.4e38  # closed-slot / pad-row allocatable (f32)
INF_I = 2**30
BIG_ALLOC = np.float32(1e30)  # pad-resource allocatable: never the bottleneck

ROWS_BUCKET = 64
RES_BUCKET = 4
KEYS_BUCKET = 8
WORDS_BUCKET = 2
TAINT_BUCKET = 4
GROUP_BUCKET = 8
PORT_BUCKET = 4
RANK_BUCKET = 4
EXIST_BUCKET = 32
ITEM_BUCKET = 64
SLOTS_BUCKET = 512


def bucket(n: int, m: int) -> int:
    """Round n up to a multiple of m (minimum m)."""
    return -(-max(n, 1) // m) * m


# High-water bucketing: once an axis has been seen at a size, later calls pad
# up to it, so a workload oscillating around a bucket boundary keeps one
# shape. The marks are this package's own (never shared with the reference);
# KARPENTER_SOLVER_BUCKET=0 turns the ladder off (plain bucketing).
_BUCKET_HW: dict[str, int] = {}


def highwater_enabled() -> bool:
    return os.environ.get("KARPENTER_SOLVER_BUCKET", "1").strip().lower() not in ("0", "false", "off")


def bucket_hw(axis: str, n: int, m: int) -> int:
    """`bucket(n, m)` raised to the axis' high-water mark; growth past an
    established mark overshoots by >= 12.5% (rounded to the bucket)."""
    t = -(-max(n, 1) // m) * m
    if not highwater_enabled():
        return t
    hw = _BUCKET_HW.get(axis, 0)
    if t <= hw:
        return hw
    if hw:
        t = max(t, -(-(hw + max(m, hw // 8)) // m) * m)
    _BUCKET_HW[axis] = t
    return t


def cap_hw(axis: str, n: int) -> int:
    """High-water for already-laddered values (the pow2 nnz caps)."""
    if not highwater_enabled():
        return n
    hw = _BUCKET_HW.get(axis, 0)
    if n <= hw:
        return hw
    _BUCKET_HW[axis] = n
    return n


def reset_bucket_highwater() -> None:
    """Drop every recorded high-water mark."""
    _BUCKET_HW.clear()


def bucket_highwater() -> dict[str, int]:
    """Snapshot of the process-global high-water marks, by axis: the
    fleet-scoped shape ladder every tenant a FleetFrontend multiplexes pads
    to. The marks are plain axis SIZES — sharing them across tenants shares
    kernel launch shapes, never tensor content (the fleet's isolation audit
    reads this surface)."""
    return dict(_BUCKET_HW)


def _pad_axis(a: np.ndarray, axis: int, target: int, fill=0) -> np.ndarray:
    n = a.shape[axis]
    if n >= target:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, target - n)
    return np.pad(a, widths, constant_values=fill)


def pad_mask_axes(mask: np.ndarray, K_p: int, W_p: int) -> np.ndarray:
    """Pad a [.., K, Words] requirement bitmask: pad words disallow, pad keys
    allow all (rows carry the absent id 0 there)."""
    mask = _pad_axis(mask, mask.ndim - 1, W_p, fill=0)
    return _pad_axis(mask, mask.ndim - 2, K_p, fill=np.uint32(0xFFFFFFFF))


def _row_domset_of(p) -> np.ndarray:
    """[Nrows, D]: domains each candidate row can produce (pinned value per
    dom key, else the template rank's value set; existing rows without the
    key carry the sentinel)."""
    Nrows, Kd = p.row_dom.shape
    dko = np.asarray(p.dom_key_of)
    ranks = np.asarray(p.row_pool_rank)
    Q = p.rank_domset.shape[0]
    rd = np.zeros((Nrows, p.n_doms), dtype=bool)
    for k in range(Kd):
        col = p.row_dom[:, k]
        pinned = col != k  # the per-key sentinel id is k
        rd[np.nonzero(pinned)[0], col[pinned]] = True
        un_off = ~pinned & (ranks >= 0)
        if un_off.any():
            rd[un_off] |= p.rank_domset[np.clip(ranks[un_off], 0, Q - 1)] & (dko == k)[None, :]
        rd[~pinned & (ranks < 0), k] = True
    return rd


def _rank_dom_cap_of(p) -> np.ndarray:
    """[Q, D, R]: per (rank, domain) the max allocatable among the rank's
    offering rows that can produce the domain; NEG where there is none."""
    Q = p.rank_domset.shape[0]
    R = p.row_alloc.shape[1]
    cap = np.full((Q, p.n_doms, R), np.float32(NEG), dtype=np.float32)
    ranks = np.asarray(p.row_pool_rank)
    off = np.nonzero(ranks >= 0)[0]
    if off.size:
        rd = _row_domset_of(p)[off]
        ri, di = np.nonzero(rd)
        np.maximum.at(cap, (ranks[off][ri], di), p.row_alloc[off][ri])
    return cap


@dataclass
class SchedulerTensors:
    """Device tensors of one problem, every workload axis padded to its
    bucket (pad rows never fit, pad groups have kind -1, pad resources are
    huge, pad ports are empty, pad taint classes tolerate all)."""

    n_rows_real: int
    row_alloc: torch.Tensor  # [Nrows, R] f32
    row_labels: torch.Tensor  # [Nrows, K] i32
    row_pool_rank: torch.Tensor  # [Nrows] i32
    row_taint_class: torch.Tensor  # [Nrows] i32
    rank_domset: torch.Tensor  # [Q, D] bool
    rank_dom_cap: torch.Tensor  # [Q, D, R] f32
    dom_key_of: torch.Tensor  # [D] i32
    group_kind: torch.Tensor  # [G] i32
    group_skew: torch.Tensor  # [G] i32
    group_dom_key: torch.Tensor  # [G] i32
    group_min_domains: torch.Tensor  # [G] i32
    group_registered: torch.Tensor  # [G, D] bool
    counts_dom_init: torch.Tensor  # [G, D] i32
    counts_host_init: torch.Tensor  # [G, N] i32
    existing_domset: torch.Tensor  # [n_ex, D] bool
    existing_port_any: torch.Tensor  # [n_ex, P1] bool
    existing_port_wild: torch.Tensor  # [n_ex, P1] bool
    existing_port_spec: torch.Tensor  # [n_ex, P2] bool
    row_port_any: torch.Tensor  # [Nrows, P1] bool
    row_port_wild: torch.Tensor  # [Nrows, P1] bool
    row_port_spec: torch.Tensor  # [Nrows, P2] bool
    dom_keys: tuple  # vocab key id per dom key (-1 if absent)
    forced_keys: torch.Tensor  # [K] bool: the label keys compat_matrix forces true (from dom_keys)
    n_existing: int
    n_slots: int

    @property
    def device(self) -> torch.device:
        return self.row_alloc.device


def make_tensors(p, device, n_slots: int | None = None) -> SchedulerTensors:
    """EncodedProblem (numpy) -> SchedulerTensors on `device`. Only the
    grouped pack's inputs: the per-pod tensors are not built."""
    if n_slots is None:
        n_slots = p.n_existing + p.n_pods
    n_slots = bucket_hw("slots", int(n_slots), SLOTS_BUCKET)
    G = max(p.n_groups, 1)
    D = p.n_doms
    Nrows = p.row_alloc.shape[0]
    Nrows_p = bucket_hw("rows", Nrows, ROWS_BUCKET)
    R_p = bucket_hw("res", p.row_alloc.shape[1], RES_BUCKET)
    K_p = bucket_hw("keys", p.sig_mask.shape[1], KEYS_BUCKET)
    bucket_hw("words", p.sig_mask.shape[2], WORDS_BUCKET)
    bucket_hw("taints", p.sig_taint_ok.shape[1], TAINT_BUCKET)
    G_p = bucket_hw("groups", G, GROUP_BUCKET)
    P1_p = bucket_hw("ports1", p.row_port_any.shape[1], PORT_BUCKET)
    P2_p = bucket_hw("ports2", p.row_port_spec.shape[1], PORT_BUCKET)

    row_alloc = _pad_axis(p.row_alloc.astype(np.float32), 1, R_p, fill=BIG_ALLOC)
    row_alloc = _pad_axis(row_alloc, 0, Nrows_p, fill=np.float32(NEG))
    row_labels = _pad_axis(_pad_axis(p.row_labels, 1, K_p), 0, Nrows_p)
    row_pool_rank = _pad_axis(p.row_pool_rank, 0, Nrows_p)
    row_taint_class = _pad_axis(p.row_taint_class, 0, Nrows_p)
    Q_p = bucket_hw("rank", p.rank_domset.shape[0], RANK_BUCKET)
    rank_domset = _pad_axis(p.rank_domset, 0, Q_p, fill=False)
    rank_dom_cap = _pad_axis(_rank_dom_cap_of(p), 2, R_p, fill=BIG_ALLOC)
    rank_dom_cap = _pad_axis(rank_dom_cap, 0, Q_p, fill=np.float32(NEG))
    row_port_any = _pad_axis(_pad_axis(p.row_port_any, 1, P1_p, fill=False), 0, Nrows_p, fill=False)
    row_port_wild = _pad_axis(_pad_axis(p.row_port_wild, 1, P1_p, fill=False), 0, Nrows_p, fill=False)
    row_port_spec = _pad_axis(_pad_axis(p.row_port_spec, 1, P2_p, fill=False), 0, Nrows_p, fill=False)

    has_groups = p.n_groups > 0
    counts_host = np.zeros((G_p, n_slots), dtype=np.int32)
    if has_groups and p.n_existing:
        counts_host[: p.n_groups, : p.n_existing] = p.counts_host_existing[:, : p.n_existing]
    group_kind = _pad_axis(p.group_kind if has_groups else np.zeros(1, np.int32), 0, G_p, fill=-1)
    group_skew = _pad_axis(p.group_skew if has_groups else np.ones(1, np.int32), 0, G_p, fill=1)
    group_dom_key = _pad_axis(p.group_dom_key if has_groups else np.full(1, -1, np.int32), 0, G_p, fill=-1)
    group_min_domains = _pad_axis(p.group_min_domains if has_groups else np.zeros(1, np.int32), 0, G_p)
    group_registered = _pad_axis(p.group_registered if has_groups else np.zeros((1, D), bool), 0, G_p, fill=False)
    counts_dom = _pad_axis(p.counts_dom_init if has_groups else np.zeros((1, D), np.int32), 0, G_p)

    n_ex = bucket_hw("exist", p.n_existing, EXIST_BUCKET)
    existing_domset = np.zeros((n_ex, D), dtype=bool)
    if p.n_existing:
        existing_domset[np.arange(p.n_existing)[:, None], p.row_dom[: p.n_existing]] = True

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def ports(a, width):
        return dev(_pad_axis(_pad_axis(a, 1, width, fill=False), 0, n_ex, fill=False), torch.bool)

    return SchedulerTensors(
        n_rows_real=int(Nrows),
        row_alloc=dev(row_alloc, torch.float32),
        row_labels=dev(row_labels, torch.int32),
        row_pool_rank=dev(row_pool_rank, torch.int32),
        row_taint_class=dev(row_taint_class, torch.int32),
        rank_domset=dev(rank_domset, torch.bool),
        rank_dom_cap=dev(rank_dom_cap, torch.float32),
        dom_key_of=dev(p.dom_key_of, torch.int32),
        group_kind=dev(group_kind, torch.int32),
        group_skew=dev(group_skew, torch.int32),
        group_dom_key=dev(group_dom_key, torch.int32),
        group_min_domains=dev(group_min_domains, torch.int32),
        group_registered=dev(group_registered, torch.bool),
        counts_dom_init=dev(counts_dom, torch.int32),
        counts_host_init=dev(counts_host, torch.int32),
        existing_domset=dev(existing_domset, torch.bool),
        existing_port_any=ports(p.existing_port_any, P1_p),
        existing_port_wild=ports(p.existing_port_wild, P1_p),
        existing_port_spec=ports(p.existing_port_spec, P2_p),
        row_port_any=dev(row_port_any, torch.bool),
        row_port_wild=dev(row_port_wild, torch.bool),
        row_port_spec=dev(row_port_spec, torch.bool),
        dom_keys=tuple(int(k) for k in p.dom_vocab_keys),
        forced_keys=forced_key_mask(p.dom_vocab_keys, K_p, device),
        n_existing=int(p.n_existing),
        n_slots=int(n_slots),
    )


@dataclass
class PodTensors:
    """Per-pod inputs of the per-pod pack, in FFD queue order: each pod's
    signature arrays, padded to the buckets of the SchedulerTensors they go
    with (pad resources request 0, pad mask words allow nothing, pad keys
    allow all, pad taint classes are tolerated, pad groups hold nobody)."""

    pod_req: torch.Tensor  # [P, R] f32
    pod_mask: torch.Tensor  # [P, K, Words] i32 words
    pod_taint_ok: torch.Tensor  # [P, C] bool
    pod_dom_allowed: torch.Tensor  # [P, D] bool
    pod_restrict: torch.Tensor  # [P, Kd] bool
    member: torch.Tensor  # [P, G] bool
    owner: torch.Tensor  # [P, G] bool


def make_pod_tensors(p, device, t: SchedulerTensors) -> PodTensors:
    """EncodedProblem -> PodTensors on `device`, padded like `t` (the
    `with_pods` half of the reference's make_tensors)."""
    P = p.n_pods
    sig = np.asarray(p.sig_of_pod, dtype=np.int64)
    R_p = t.row_alloc.shape[1]
    K_p = t.row_labels.shape[1]
    G_p = t.group_kind.shape[0]
    W_p = bucket_hw("words", p.sig_mask.shape[2], WORDS_BUCKET)
    C_p = bucket_hw("taints", p.sig_taint_ok.shape[1], TAINT_BUCKET)
    groups = p.n_groups > 0

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return PodTensors(
        pod_req=dev(_pad_axis(p.sig_req[sig], 1, R_p), torch.float32),
        pod_mask=dev(as_int32_words(pad_mask_axes(p.sig_mask[sig], K_p, W_p)), torch.int32),
        pod_taint_ok=dev(_pad_axis(p.sig_taint_ok[sig], 1, C_p, fill=True), torch.bool),
        pod_dom_allowed=dev(p.sig_dom_allowed[sig], torch.bool),
        pod_restrict=dev(p.sig_restrict[sig], torch.bool),
        member=dev(_pad_axis(p.sig_member[sig] if groups else np.zeros((P, 1), bool), 1, G_p, fill=False), torch.bool),
        owner=dev(_pad_axis(p.sig_owner[sig] if groups else np.zeros((P, 1), bool), 1, G_p, fill=False), torch.bool),
    )


def forced_key_mask(dom_keys, K: int, device) -> torch.Tensor:
    """[K] bool on `device`: the label keys that are dom keys, which
    compat_matrix forces true. An id outside [0, K) (-1 for an absent key)
    forces nothing, as the reference's out-of-bounds scatter drops it."""
    forced = np.zeros(K, dtype=bool)
    for kk in dom_keys:
        if 0 <= kk < K:
            forced[kk] = True
    return torch.as_tensor(forced).to(device)


def compat_matrix(row_labels, row_taint_class, masks, taints_ok, dom_keys: tuple) -> torch.Tensor:
    """Plain requirement-mask x row compatibility: [B, Nrows] bool. `masks`
    are [B, K, Words] int32 words; dom-key columns are forced true (the slot
    domain sets handle them); the taint class of each row must be tolerated
    (read as the reference's gather reads it: a negative class counts from
    the end once, then it is clamped to [0, C))."""
    B = masks.shape[0]
    Nrows, K = row_labels.shape
    bm = masks.unsqueeze(1).expand(B, Nrows, K, masks.shape[-1])
    ok = test_bit(bm, row_labels.unsqueeze(0).expand(B, Nrows, K))  # [B, Nrows, K]
    ok = ok | forced_key_mask(dom_keys, K, masks.device)
    C = taints_ok.shape[1]
    tc = row_taint_class.to(torch.int64)
    tcls = torch.clamp(torch.where(tc < 0, tc + C, tc), 0, C - 1)  # the reference's gather: wrap once, clamp
    return ok.all(dim=2) & taints_ok[:, tcls]


def row_choose_key(row_alloc, row_pool_rank, req) -> torch.Tensor:
    """New-slot row preference: rank * 1e9 - min(min_r alloc / req, 1e8);
    req [B, R] -> [B, Nrows] f32 (lower is better)."""
    score = torch.amin(row_alloc.unsqueeze(0) / torch.clamp_min(req.unsqueeze(1), 1e-6), dim=2)
    rank = row_pool_rank.to(torch.float32).unsqueeze(0) * torch.tensor(1e9, dtype=torch.float32, device=req.device)
    return rank - torch.clamp_max(score, 1e8)


def group_feasibility(t: SchedulerTensors, mem):
    """Keyed-domain membership of pods `mem` [..., G]: (dom_member_mask
    [..., G], is_dom_member [...], kmask [..., D]) — the groups that
    constrain the pod, whether any do, and the domains of its constrained
    key (the highest dom key among its groups)."""
    dom_member_mask = mem & ((t.group_kind == KIND_DOM_SPREAD) | (t.group_kind == KIND_DOM_ANTI))
    k_star = torch.where(dom_member_mask, t.group_dom_key, -1).amax(dim=-1)
    return dom_member_mask, dom_member_mask.any(dim=-1), t.dom_key_of == k_star.unsqueeze(-1)


def spread_ok_of(t: SchedulerTensors, za, dom_member_mask, counts_dom) -> torch.Tensor:
    """[D] bool from the current counts: every member group's skew check
    (anti: the domain is empty) passes over its registered universe."""
    reg = t.group_registered
    zr = za.unsqueeze(0) & reg
    zmin = torch.where(zr, counts_dom, INF_I).amin(dim=1)
    zmin = torch.where(zmin >= INF_I, 0, zmin)
    supported = zr.sum(dim=1, dtype=torch.int32)
    zmin = torch.where((t.group_min_domains > 0) & (supported < t.group_min_domains), 0, zmin)
    is_anti = (t.group_kind == KIND_DOM_ANTI).unsqueeze(1)
    per_group_ok = torch.where(is_anti, counts_dom == 0, (counts_dom + 1 - zmin.unsqueeze(1)) <= t.group_skew.unsqueeze(1))
    per_group_ok = per_group_ok & reg
    return torch.where(dom_member_mask.unsqueeze(1), per_group_ok, True).all(dim=0)


def perkey_dom_ok(domsets, za, restrict, dom_key_of) -> torch.Tensor:
    """[..., D] domain sets -> [...] bool: for every dom key the pod
    constrains, the set retains at least one allowed domain of that key."""
    Kd = restrict.shape[0]
    key_onehot = dom_key_of.unsqueeze(0) == torch.arange(Kd, dtype=dom_key_of.dtype, device=dom_key_of.device).unsqueeze(1)
    inter = domsets & za
    perkey = (inter.unsqueeze(-2) & key_onehot).any(dim=-1)  # [..., Kd]
    return (perkey | ~restrict).all(dim=-1)


# -- the per-pod pack ----------------------------------------------------------


def greedy_pack_plain(t: SchedulerTensors, pods: PodTensors, compat, key):
    """Plain PyTorch version of the per-pod FFD scan (the reference's
    `_greedy_pack_impl`, its `step` pod by pod). compat [P, Nrows] and key
    [P, Nrows] are K1's outputs over the pods. Each pod goes to the first
    open slot that fits it, else opens a slot on the best fitting row.
    Returns the reference's five outputs (assignment [P] i32, slot_basis
    [N], slot_domset [N, D], slot_rank [N], open_count i32) and then the
    rest of the final carry (slot_rem [N, R], counts_dom [G, D],
    counts_host [G, N]).

    Like the reference it ignores host ports, required pod affinity and
    `sig_host_blocked`. Terms that depend on the pod and the groups only
    are computed for all pods before the scan; a pod that nothing fits
    leaves the state as it was (every increment of the reference is 0
    there)."""
    from .scheduler_model_grouped import initial_state

    dev = t.device
    P = pods.pod_req.shape[0]
    N = t.n_slots
    Nrows = t.row_alloc.shape[0]
    D = t.counts_dom_init.shape[1]
    Q = t.rank_domset.shape[0]
    slot_basis, slot_rem, slot_domset, slot_rank, counts_dom, counts_host = initial_state(t, N)[:6]
    open_count = t.n_existing
    assignment = torch.full((P,), -1, dtype=torch.int32, device=dev)

    kind, dko = t.group_kind, t.dom_key_of
    dom_member, is_dom_member, kmask = group_feasibility(t, pods.member)
    spread_member = pods.member & (kind == KIND_DOM_SPREAD)
    has_spread = spread_member.any(dim=1)
    anti_member = pods.member & (kind == KIND_DOM_ANTI)
    host_member = (pods.member & ((kind == KIND_HOST_SPREAD) | (kind == KIND_HOST_ANTI))).to(torch.int32)
    rows = torch.arange(Nrows, device=dev)
    row_ok = compat & ((rows >= t.n_existing) & (rows < t.n_rows_real)).unsqueeze(0)
    row_ok &= (pods.pod_req.unsqueeze(1) <= t.row_alloc.unsqueeze(0)).all(dim=2)
    rank_of_row = torch.clamp(t.row_pool_rank, 0, Q - 1).to(torch.int64)
    doms = torch.arange(D, device=dev)
    # host facts of each pod, on the host: (is_dom_member, has_spread,
    # owned hostname-spread groups, owned hostname-anti groups)
    own_hs = (pods.owner & (kind == KIND_HOST_SPREAD)).cpu()
    own_ha = (pods.owner & (kind == KIND_HOST_ANTI)).cpu()
    flags = torch.stack([is_dom_member, has_spread], dim=1).cpu().tolist()

    for i in range(P):
        req, za, restrict = pods.pod_req[i], pods.pod_dom_allowed[i], pods.pod_restrict[i]
        dm, spread = flags[i]
        dom_feasible = za & spread_ok_of(t, za, dom_member[i], counts_dom) if dm else za

        # open slots: the first that fits
        fits = (slot_basis >= 0) & (req <= slot_rem).all(dim=1)
        fits &= compat[i][torch.clamp(slot_basis, 0, Nrows - 1).to(torch.int64)]
        fits &= perkey_dom_ok(slot_domset, za, restrict, dko)
        if dm:
            fits &= (slot_domset & dom_feasible).any(dim=1)
        for g in own_hs[i].nonzero().flatten().tolist():
            fits &= (counts_host[g] + 1) <= t.group_skew[g]
        for g in own_ha[i].nonzero().flatten().tolist():
            fits &= counts_host[g] == 0
        j_slot = int(first_true_index(fits))

        # a new slot: the fitting offering row with the lowest key
        o_new = -1
        if open_count < N:
            rank_ok = perkey_dom_ok(t.rank_domset, za, restrict, dko)
            if dm:
                rank_ok &= (t.rank_domset & dom_feasible).any(dim=1)
            o_new = int(masked_argmin(key[i], row_ok[i] & rank_ok[rank_of_row]))

        use_slot = j_slot >= 0
        j = j_slot if use_slot else (open_count if o_new >= 0 else -1)
        if j < 0:
            continue
        safe_o = min(max(o_new, 0), Nrows - 1)

        # domain commitment: spread members commit to the least-counted
        # feasible domain of their key (ties, and no feasible one, to 0)
        cur = slot_domset[j] if use_slot else t.rank_domset[int(rank_of_row[safe_o])]
        cur = cur & torch.where(kmask[i] & dm, dom_feasible, za)
        per_dom = torch.where(dom_member[i].unsqueeze(1), counts_dom, 0).sum(dim=0).to(torch.int32)
        z_star = int(torch.argmin(torch.where(cur & kmask[i], per_dom, INF_I)))
        new_domset = torch.where(kmask[i], doms == z_star, cur) & cur if dm and spread else cur

        slot_basis[j] = slot_basis[j] if use_slot else o_new
        slot_rem[j] = (slot_rem[j] if use_slot else t.row_alloc[safe_o]) - req
        slot_domset[j] = new_domset
        if not use_slot:
            slot_rank[j] = t.row_pool_rank[safe_o]
            open_count += 1
        if dm:
            counts_dom[:, z_star] += spread_member[i].to(torch.int32)
        counts_dom += (anti_member[i].unsqueeze(1) & (new_domset & kmask[i]).unsqueeze(0)).to(torch.int32)
        counts_host[:, j] += host_member[i]
        assignment[i] = j

    open_t = torch.tensor(open_count, dtype=torch.int32, device=dev)
    return assignment, slot_basis, slot_domset, slot_rank, open_t, slot_rem, counts_dom, counts_host


def greedy_pack(t: SchedulerTensors, pods: PodTensors):
    """The per-pod pack: K1 over the pods (compatibility and row key), then
    K8, each through its kernel wrapper (the kernel on CUDA tensors, the
    plain version on CPU tensors). Returns (assignment [P] -> slot or -1,
    slot_basis [N], slot_domset [N, D], slot_rank [N], open_count).

    Like the reference's legacy per-pod entry it does not enforce host
    ports, required pod affinity or inverse anti-affinity blocks; the
    grouped pack is the production path."""
    from ..kernels.feasibility import compat_and_key
    from ..kernels.perpod_pack import perpod_pack

    compat, key = compat_and_key(t, pods.pod_mask, pods.pod_taint_ok, pods.pod_req)
    return perpod_pack(t, pods, compat, key)[:5]


def greedy_pack_encoded(p, device=None):
    """`greedy_pack` of an EncodedProblem on `device` (CUDA unless the
    caller names the CPU), on the reference's default slot axis:
    n_existing + P, bucketed. Returns its five outputs."""
    dev = resolve_device(device)
    t = make_tensors(p, dev)
    return greedy_pack(t, make_pod_tensors(p, dev, t))
