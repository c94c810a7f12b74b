"""K6 score_subsets: the discrete factored objective of each delete-set.

`score_subsets` launches `csrc/score_subsets.cu` for CUDA tensors (one
block per row, every row in one launch; any R, Qp and Np) and runs the plain
`objective_factored_plain` for CPU tensors. Returns (score [M] f32,
feasible [M] bool)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.globalpack import objective_factored_plain
from . import build

score_subsets_plain = objective_factored_plain


def score_subsets(t, onehot, compat_nq, pend_req, pend_npods: float, pend_active, X):
    """t: ConsolidationTensors; onehot / compat_nq [Np, Qp], pend_req [R],
    pend_active [Qp] (f32), pend_npods a float, X [M, Np] bool."""
    dev = X.device
    if dev.type == "cpu":
        return objective_factored_plain(t, onehot, compat_nq, pend_req, pend_npods, pend_active, X)
    if dev.type != "cuda":
        raise ValueError(f"score_subsets: unsupported device {dev}")
    M, N = X.shape
    R = t.node_used.shape[1]
    Q = onehot.shape[1]
    T = t.row_price.shape[0]
    if onehot.shape != (N, Q) or compat_nq.shape != (N, Q) or pend_req.shape != (R,) or pend_active.shape != (Q,):
        raise ValueError("score_subsets: node or class axes disagree")
    f = torch.float32
    args = [
        build.require(t.node_price, dev, f, "node_price"),
        build.require(t.node_cost, dev, f, "node_cost"),
        build.require(t.node_slack, dev, f, "node_slack"),
        build.require(t.node_used, dev, f, "node_used"),
        build.require(t.node_npods, dev, f, "node_npods"),
        build.require(onehot, dev, f, "onehot"),
        build.require(compat_nq, dev, f, "compat_nq"),
        build.require(t.row_alloc, dev, f, "row_alloc"),
        build.require(t.row_price, dev, f, "row_price"),
        build.require(pend_req, dev, f, "pend_req"),
        build.require(pend_active, dev, f, "pend_active"),
        build.require(X, dev, torch.bool, "X"),
    ]
    score = torch.empty(M, dtype=f, device=dev)
    feasible = torch.empty(M, dtype=torch.bool, device=dev)
    # the kernel's tables past its shared-memory budget (large Np) go here
    n_scratch = build.lib().kt_score_subsets_scratch(M, N, R, Q)
    scratch = torch.empty(n_scratch, dtype=f, device=dev) if n_scratch else None
    rc = build.lib().kt_score_subsets(*[a.data_ptr() for a in args], M, N, R, Q, T,
                                      ctypes.c_float(float(np.float32(pend_npods))),
                                      ctypes.c_float(float(np.float32(t.churn_weight))),
                                      score.data_ptr(), feasible.data_ptr(),
                                      scratch.data_ptr() if scratch is not None else None, build.stream_ptr(dev))
    build.check(rc, "score_subsets")
    build.LAUNCHES["score_subsets"] += 1
    return score, feasible
