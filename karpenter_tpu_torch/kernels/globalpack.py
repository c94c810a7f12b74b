"""K5 globalpack: projected Adam ascent on the relaxed global repack.

`globalpack` launches `csrc/globalpack.cu` for CUDA tensors (a cluster of
blocks per init runs every step, each block's slice of the state on chip;
any R, Qp and Np) and runs `globalpack_plain` for CPU tensors. Both start
from d0 [C, Np] and y0 [C, Qp, Np] (yr = 0.5 before the first
projection) and return (d [C, Np], score [C])."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.globalpack import (
    ADAM,
    adam_corrections,
    gp_grad_plain,
    gp_normalisers,
    gp_objective_plain,
    gp_project,
)
from . import build


def globalpack_plain(t, onehot, compat_qn, pend_mass, pend_weight, d0, y0, n_iters: int):
    """The reference's `_globalpack_impl` from explicit inits, batched over C."""
    dev = d0.device
    price_safe, inv_alloc, norm_r = gp_normalisers(t, pend_mass)
    C, Q, T = d0.shape[0], onehot.shape[1], t.row_price.shape[0]
    d = d0.clone()
    y, yr = gp_project(y0, torch.full((C, Q, T), 0.5, device=dev), compat_qn)
    state = [d, y, yr]
    m = [torch.zeros_like(x) for x in state]
    v = [torch.zeros_like(x) for x in state]
    corr = torch.from_numpy(adam_corrections(max(n_iters, 1))).to(dev)  # device 0-d divisors: IEEE division
    b1, b2, c1, c2, lr, eps = (float(ADAM[k]) for k in ("b1", "b2", "c1", "c2", "lr", "eps"))
    args = (t, onehot, compat_qn, pend_mass, pend_weight)
    norms = (inv_alloc, norm_r, price_safe)
    for i in range(n_iters):
        g = gp_grad_plain(*args, *state, *norms)
        m = [b1 * mi + c1 * gi for mi, gi in zip(m, g)]
        v = [b2 * vi + (c2 * gi) * gi for vi, gi in zip(v, g)]
        upd = [(mi / corr[i, 0]) / (torch.sqrt(vi / corr[i, 1]) + eps) for mi, vi in zip(m, v)]
        d = torch.clamp(state[0] - lr * upd[0], 0.0, 1.0)
        y, yr = gp_project(state[1] - lr * upd[1], state[2] - lr * upd[2], compat_qn)
        state = [d, y, yr]
    return state[0], gp_objective_plain(*args, *state, *norms)


def globalpack(t, onehot, compat_qn, pend_mass, pend_weight, d0, y0, n_iters: int):
    """t: ConsolidationTensors; onehot [Np, Qp], compat_qn [Qp, Np],
    pend_mass [Qp, R], pend_weight [Qp], d0 [C, Np], y0 [C, Qp, Np] (f32)."""
    dev = d0.device
    if dev.type == "cpu":
        return globalpack_plain(t, onehot, compat_qn, pend_mass, pend_weight, d0, y0, n_iters)
    if dev.type != "cuda":
        raise build.KernelArgError(f"globalpack: unsupported device {dev}")
    C, N = d0.shape
    R = t.node_used.shape[1]
    Q = onehot.shape[1]
    T = t.row_price.shape[0]
    if y0.shape != (C, Q, N) or onehot.shape != (N, Q) or compat_qn.shape != (Q, N) or pend_mass.shape != (Q, R):
        raise build.KernelArgError("globalpack: init or class axes disagree")
    f = torch.float32
    corr = torch.from_numpy(adam_corrections(max(n_iters, 1))).to(dev)
    args = [
        build.require(t.node_price, dev, f, "node_price"),
        build.require(t.node_cost, dev, f, "node_cost"),
        build.require(t.node_slack, dev, f, "node_slack"),
        build.require(t.node_used, dev, f, "node_used"),
        build.require(t.row_price, dev, f, "row_price"),
        build.require(t.row_alloc, dev, f, "row_alloc"),
        build.require(onehot, dev, f, "onehot"),
        build.require(compat_qn, dev, f, "compat_qn"),
        build.require(pend_mass, dev, f, "pend_mass"),
        build.require(pend_weight, dev, f, "pend_weight"),
        build.require(d0, dev, f, "d0"),
        build.require(y0, dev, f, "y0"),
        corr,
    ]
    d = torch.empty_like(d0)
    score = torch.empty(C, dtype=f, device=dev)
    lib = build.lib()
    # the blocks' state past the shared-memory budget (large R, Qp or Np) goes here
    n_scratch = lib.kt_globalpack_scratch(C, N, R, Q, T)
    scratch = torch.empty(n_scratch, dtype=f, device=dev) if n_scratch else None
    consts = [ctypes.c_float(float(ADAM[k])) for k in ("b1", "b2", "c1", "c2", "lr", "eps")]
    rc = lib.kt_globalpack(*[a.data_ptr() for a in args], C, N, R, Q, T, int(n_iters),
                           ctypes.c_float(float(np.float32(t.churn_weight))), *consts, d.data_ptr(), score.data_ptr(),
                           scratch.data_ptr() if scratch is not None else None, build.stream_ptr(dev))
    build.check(rc, "globalpack")
    build.LAUNCHES["globalpack"] += 1
    return d, score
