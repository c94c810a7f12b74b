"""Device tensors of the scheduler and the per-step helper functions.

Counterpart of the reference's `models/scheduler_model.py` on the grouped
pack's path: the shape-bucket ladder (with this package's own high-water
marks), `make_tensors` without the per-pod tensors, and the plain versions
of `compat_matrix`, `row_choose_key`, `spread_ok_of` and `perkey_dom_ok`.

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

from ..ops.bitset import test_bit
from ..solver.encoded import KIND_DOM_ANTI

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
        n_existing=int(p.n_existing),
        n_slots=int(n_slots),
    )


def compat_matrix(row_labels, row_taint_class, masks, taints_ok, dom_keys: tuple) -> torch.Tensor:
    """Plain requirement-mask x row compatibility: [B, Nrows] bool. `masks`
    are [B, K, Words] int32 words; dom-key columns are forced true (the slot
    domain sets handle them); the taint class of each row must be tolerated."""
    B = masks.shape[0]
    Nrows, K = row_labels.shape
    bm = masks.unsqueeze(1).expand(B, Nrows, K, masks.shape[-1])
    ok = test_bit(bm, row_labels.unsqueeze(0).expand(B, Nrows, K))  # [B, Nrows, K]
    forced = torch.zeros(K, dtype=torch.bool, device=masks.device)
    for kk in dom_keys:
        if 0 <= kk < K:
            forced[kk] = True
    ok = ok | forced
    tcls = torch.clamp(row_taint_class.to(torch.int64), 0, taints_ok.shape[1] - 1)
    return ok.all(dim=2) & taints_ok[:, tcls]


def row_choose_key(row_alloc, row_pool_rank, req) -> torch.Tensor:
    """New-slot row preference: rank * 1e9 - min(min_r alloc / req, 1e8);
    req [B, R] -> [B, Nrows] f32 (lower is better)."""
    score = torch.amin(row_alloc.unsqueeze(0) / torch.clamp_min(req.unsqueeze(1), 1e-6), dim=2)
    rank = row_pool_rank.to(torch.float32).unsqueeze(0) * torch.tensor(1e9, dtype=torch.float32, device=req.device)
    return rank - torch.clamp_max(score, 1e8)


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
