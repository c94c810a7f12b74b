"""K7 anneal: simulated-annealing chains over single-bit flips of a
delete-set, scored by the discrete objective.

`anneal` launches `csrc/anneal.cu` for CUDA tensors (one block per chain
walks all S steps) and runs `anneal_plain` for CPU tensors. The random
streams come in as tensors: x0 [C, Np] bool, flips [C, S] int32,
u [C, S] f32. Returns (best_x [C, Np] bool, best_s [C] f32).

Both read `pod_compat` as a 0/1 matrix (the encoder builds it from a 0/1
table): the reference's max_i pod_compat[j, i] x[i] is then "some deleted i
with pod_compat[j, i] == 1", which the kernel keeps as a per-node count."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.consolidation_model import objective_plain
from . import build

MAX_R = 16
SMEM_LIMIT = 224 * 1024  # dynamic shared memory a block may take on an H100 (227 KB), less the static part


def xla_sums_scratch(n: int, series: int) -> int:
    """Floats of scratch `csrc/xla_order.cuh` needs for `series` sums of n
    terms: one slot per window sum at every level."""
    slots = 0
    while n > 32:
        slots += n // 32
        n //= 32
    return series * slots


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
    if R > MAX_R:
        raise ValueError(f"anneal: R={R} above the kernel's limit {MAX_R}")
    if t.pod_compat.shape != (N, N) or flips.shape != (C, S) or u.shape != (C, S):
        raise ValueError("anneal: pod_compat must be the dense [Np, Np] form, streams [C, S]")
    smem = ((N + 15) // 16) * 16 + 8 * N + 4 * xla_sums_scratch(N, R + 3)
    if smem > SMEM_LIMIT:
        raise ValueError(f"anneal: Np={N} needs {smem} bytes of shared memory, above {SMEM_LIMIT}")
    f = torch.float32
    pc = build.require(t.pod_compat, dev, f, "pod_compat")
    if not bool(((pc == 0) | (pc == 1)).all()):
        raise ValueError("anneal: pod_compat must hold only 0 and 1")
    if flips.numel() and not (0 <= int(flips.min()) and int(flips.max()) < N):
        raise ValueError(f"anneal: flips outside [0, {N})")
    pc_t = pc.t().contiguous()  # row i: the hosts j of deleted node i, read per flip
    args = [
        build.require(t.node_price, dev, f, "node_price"),
        build.require(t.node_cost, dev, f, "node_cost"),
        build.require(t.node_slack, dev, f, "node_slack"),
        build.require(t.node_used, dev, f, "node_used"),
        build.require(t.node_npods, dev, f, "node_npods"),
        pc_t,
        build.require(t.row_alloc, dev, f, "row_alloc"),
        build.require(t.row_price, dev, f, "row_price"),
        build.require(x0, dev, torch.bool, "x0"),
        build.require(flips, dev, torch.int32, "flips"),
        build.require(u, dev, f, "u"),
    ]
    best_x = torch.empty_like(x0)
    best_s = torch.empty(C, dtype=f, device=dev)
    rc = build.lib().kt_anneal(*[a.data_ptr() for a in args], C, N, R, T, S,
                               ctypes.c_float(float(np.float32(t.churn_weight))), best_x.data_ptr(),
                               best_s.data_ptr(), build.stream_ptr(dev))
    build.check(rc, "anneal")
    build.LAUNCHES["anneal"] += 1
    return best_x, best_s
