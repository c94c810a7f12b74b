"""K7 anneal: simulated-annealing chains over single-bit flips of a
delete-set, scored by the discrete objective.

`anneal` launches `csrc/anneal.cu` for CUDA tensors and runs `anneal_plain`
for CPU tensors. The random streams come in as tensors: x0 [C, Np] bool,
flips [C, S] int32, u [C, S] f32. Returns (best_x [C, Np] bool, best_s [C]
f32). On the card it makes two launches: the pre-pass `anneal_prepass`
(counted as "anneal_pack") packs the dense 0/1 `pod_compat` into bit rows,
checks it and the flips, and marks the replacement rows no other row
dominates; then K7 (counted as "anneal"), one block per chain walking all S
steps (any R and Np).

Both read `pod_compat` as a 0/1 matrix (the encoder builds it from a 0/1
table): the reference's max_i pod_compat[j, i] x[i] is then "some deleted i
with pod_compat[j, i] == 1", which the kernel keeps as a per-node count."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.consolidation_model import objective_plain
from . import build

def temperature_fractions(n_steps: int) -> np.ndarray:
    """[S] f32 max(0.02, 1 - i / S), as the reference forms it in float32."""
    i = np.arange(n_steps, dtype=np.float32)
    return np.maximum(np.float32(0.02), np.float32(1.0) - i / np.float32(n_steps))


def fma(a, b: float, c: float):
    """a * b + c rounded once (XLA:CPU contracts the reference's
    `abs(s) * 0.1 + 1e-3` into a fused multiply-add), for float32 a."""
    f32 = torch.float32
    return (a.double() * torch.tensor(b, dtype=f32).double() + torch.tensor(c, dtype=f32).double()).float()


def anneal_plain(t, x0, flips, u):
    """The reference's `anneal_chains` body, batched over the C chains."""
    dev = x0.device
    C, S = flips.shape
    rows = torch.arange(C, device=dev)
    frac = torch.from_numpy(temperature_fractions(S)).to(dev)
    x = x0.clone()
    s, _ = objective_plain(t, x)
    best_x, best_s = x.clone(), s.clone()
    for i in range(S):
        f = flips[:, i].long()
        x2 = x.clone()
        x2[rows, f] = ~x2[rows, f]
        s2, _ = objective_plain(t, x2)
        temp = frac[i] * fma(s.abs(), 0.1, 1e-3)
        accept = (s2 >= s) | (u[:, i] < torch.exp(torch.clamp((s2 - s) / temp, -50.0, 0.0)))
        x = torch.where(accept.unsqueeze(1), x2, x)
        s = torch.where(accept, s2, s)
        improved = s > best_s
        best_x = torch.where(improved.unsqueeze(1), x, best_x)
        best_s = torch.where(improved, s, best_s)
    return best_x, best_s


def pack_bits(b: torch.Tensor) -> torch.Tensor:
    """[N, M] bool -> [N, ceil(M / 32)] int32 words, bit k of word w = column
    32 w + k (the high bits of the last word 0)."""
    N, M = b.shape
    nW = (M + 31) // 32
    out = torch.empty((N, nW), dtype=torch.int32, device=b.device)
    shift = torch.arange(32, device=b.device)
    for lo in range(0, N, 1024):  # rows a chunk at a time: the int64 words of a 32768-wide matrix are 8.6 GB
        padded = torch.zeros((min(1024, N - lo), nW * 32), dtype=torch.int64, device=b.device)
        padded[:, :M] = b[lo:lo + 1024].long()
        words = (padded.reshape(-1, nW, 32) << shift).sum(-1)
        out[lo:lo + 1024] = (words - ((words >> 31) << 32)).to(torch.int32)  # as int32, bit 31 the sign
    return out


def pack_compat_plain(pc: torch.Tensor):
    """The pre-pass's packing of the dense 0/1 `pod_compat` [N, N]: (hostbits,
    delbits), [N, ceil(N / 32)] int32 each: row j of hostbits holds bit i =
    pod_compat[j, i], row i of delbits bit j = pod_compat[j, i]. Raises
    ValueError on an entry other than 0 or 1, as the kernel's flag does."""
    if not bool(((pc == 0) | (pc == 1)).all()):
        raise ValueError("anneal: pod_compat must hold only 0 and 1")
    nz = pc != 0
    return pack_bits(nz), pack_bits(nz.t())


def kept_rows_plain(row_alloc: torch.Tensor, row_price: torch.Tensor) -> torch.Tensor:
    """[T] bool: the rows that no other row dominates (at most as expensive,
    at least as large in every resource, and strictly better somewhere or
    earlier). The cheapest row covering any shortfall is among them."""
    T = row_price.shape[0]
    a, p = row_alloc, row_price
    ge = (a.unsqueeze(0) >= a.unsqueeze(1)).all(-1) & (p.unsqueeze(0) <= p.unsqueeze(1))  # [t, t2]: t2 >= t
    strict = ((a.unsqueeze(0) > a.unsqueeze(1)).any(-1) | (p.unsqueeze(0) < p.unsqueeze(1))
              | (torch.arange(T, device=p.device).unsqueeze(0) < torch.arange(T, device=p.device).unsqueeze(1)))
    dom = ge & strict
    dom.fill_diagonal_(False)
    return ~dom.any(1)


def anneal_prepass_plain(t, flips):
    """(hostbits, delbits, row_keep [T] bool) as `anneal_prepass` makes them;
    raises ValueError where the kernel raises its flag."""
    N = t.pod_compat.shape[0]
    hostbits, delbits = pack_compat_plain(t.pod_compat)
    if flips.numel() and not (0 <= int(flips.min()) and int(flips.max()) < N):
        raise ValueError(f"anneal: flips outside [0, {N})")
    return hostbits, delbits, kept_rows_plain(t.row_alloc, t.row_price)


def anneal_prepass(t, flips):
    """The pre-pass kernel on CUDA tensors: (hostbits, delbits, row_keep [T]
    bool, flag [1] int32), the flag set (1: pod_compat not 0/1, 2: a flip
    outside [0, Np)) for the caller to raise on. CPU tensors: the plain
    version, with flag 0 (it raises instead)."""
    dev = t.pod_compat.device
    if dev.type == "cpu":
        return (*anneal_prepass_plain(t, flips), torch.zeros(1, dtype=torch.int32))
    if dev.type != "cuda":
        raise ValueError(f"anneal: unsupported device {dev}")
    N = t.pod_compat.shape[0]
    T, R = t.row_alloc.shape
    if t.pod_compat.shape != (N, N):
        raise ValueError("anneal: pod_compat must be the dense [Np, Np] form")
    f = torch.float32
    pc = build.require(t.pod_compat, dev, f, "pod_compat")
    row_alloc = build.require(t.row_alloc, dev, f, "row_alloc")
    row_price = build.require(t.row_price, dev, f, "row_price")
    fl = build.require(flips, dev, torch.int32, "flips")
    nW = (N + 31) // 32
    hostbits = torch.empty((N, nW), dtype=torch.int32, device=dev)
    delbits = torch.empty((N, nW), dtype=torch.int32, device=dev)
    row_keep = torch.empty(T, dtype=torch.bool, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = build.lib().kt_anneal_pack(pc.data_ptr(), N, row_alloc.data_ptr(), row_price.data_ptr(), T, R,
                                    fl.data_ptr(), fl.numel(), hostbits.data_ptr(), delbits.data_ptr(),
                                    row_keep.data_ptr(), flag.data_ptr(), build.stream_ptr(dev))
    build.check(rc, "anneal_pack")
    build.LAUNCHES["anneal_pack"] += 1
    return hostbits, delbits, row_keep, flag


def anneal(t, x0, flips, u):
    """t: ConsolidationTensors with the dense 0/1 pod_compat [Np, Np]."""
    dev = x0.device
    if dev.type == "cpu":
        return anneal_plain(t, x0, flips, u)
    if dev.type != "cuda":
        raise ValueError(f"anneal: unsupported device {dev}")
    C, N = x0.shape
    S = flips.shape[1]
    R = t.node_used.shape[1]
    T = t.row_price.shape[0]
    if t.pod_compat.shape != (N, N) or flips.shape != (C, S) or u.shape != (C, S):
        raise ValueError("anneal: pod_compat must be the dense [Np, Np] form, streams [C, S]")
    f = torch.float32
    hostbits, delbits, row_keep, flag = anneal_prepass(t, flips)
    args = [
        build.require(t.node_price, dev, f, "node_price"),
        build.require(t.node_cost, dev, f, "node_cost"),
        build.require(t.node_slack, dev, f, "node_slack"),
        build.require(t.node_used, dev, f, "node_used"),
        build.require(t.node_npods, dev, f, "node_npods"),
        hostbits,
        delbits,
        t.row_alloc,
        t.row_price,
        row_keep,
        build.require(x0, dev, torch.bool, "x0"),
        flips,
        build.require(u, dev, f, "u"),
        flag,
    ]
    best_x = torch.empty_like(x0)
    best_s = torch.empty(C, dtype=f, device=dev)
    # each chain's state past the kernel's shared-memory budget (large Np, R or T) goes here
    n_scratch = build.lib().kt_anneal_scratch(C, N, R, T, S)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev) if n_scratch else None
    rc = build.lib().kt_anneal(*[a.data_ptr() for a in args], C, N, R, T, S,
                               ctypes.c_float(float(np.float32(t.churn_weight))), best_x.data_ptr(),
                               best_s.data_ptr(), scratch.data_ptr() if scratch is not None else None,
                               build.stream_ptr(dev))
    build.check(rc, "anneal")
    build.LAUNCHES["anneal"] += 1
    bad = int(flag.item())  # what the pre-pass flagged (waits for the card; the chains exit at once on it)
    if bad & 1:
        raise ValueError("anneal: pod_compat must hold only 0 and 1")
    if bad & 2:
        raise ValueError(f"anneal: flips outside [0, {N})")
    return best_x, best_s
