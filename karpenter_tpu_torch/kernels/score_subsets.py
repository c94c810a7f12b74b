"""K6 score_subsets: the discrete factored objective of each delete-set.

`score_subsets` launches `csrc/score_subsets.cu` for CUDA tensors (a
cluster of up to 8 blocks per row, each block a share of the node axis cut
on XLA:CPU's summation windows; every row in one launch; any R, Qp and Np)
and runs the plain `objective_factored_plain` for CPU tensors. Returns
(score [M] f32, feasible [M] bool); `score_subsets_packed` returns both in
one byte buffer (the scores' bytes, then the flags), for one download."""

from __future__ import annotations

import numpy as np
import torch

from ..models.globalpack import objective_factored_plain
from . import build

score_subsets_plain = objective_factored_plain


def score_subsets_packed(t, onehot, compat_nq, pend_req, pend_npods: float, pend_active, X):
    """K6 (CUDA tensors) or its plain version (CPU tensors) into one uint8
    tensor of 5M bytes: the M f32 scores, then the M feasibility flags."""
    dev = X.device
    if dev.type == "cpu":
        s, f = objective_factored_plain(t, onehot, compat_nq, pend_req, pend_npods, pend_active, X)
        return torch.cat([s.contiguous().view(torch.uint8), f.contiguous().view(torch.uint8)])
    if dev.type != "cuda":
        raise build.KernelArgError(f"score_subsets: unsupported device {dev}")
    M, N = X.shape
    R = t.node_used.shape[1]
    Q = onehot.shape[1]
    T = t.row_price.shape[0]
    if onehot.shape != (N, Q) or compat_nq.shape != (N, Q) or pend_req.shape != (R,) or pend_active.shape != (Q,):
        raise build.KernelArgError("score_subsets: node or class axes disagree")
    f = torch.float32
    args = (t.node_price, t.node_cost, t.node_slack, t.node_used, t.node_npods, onehot, compat_nq, t.row_alloc,
            t.row_price, pend_req, pend_active)
    # the node and row arrays stay where tensors_from_problem put them: the
    # checks copy nothing (one pass; `build.require` names the culprit)
    if not all(a.device == dev and a.dtype == f and a.is_contiguous() for a in args):
        for k, a in enumerate(args):
            build.require(a, dev, f, f"score_subsets argument {k}")
    build.require(X, dev, torch.bool, "X")
    lib = build.lib()
    out = torch.empty(5 * M, dtype=torch.uint8, device=dev)
    # the blocks' tables past their shared-memory budget (large Np or R) go here
    n_scratch = lib.kt_score_subsets_scratch(M, N, R, Q)
    scratch = torch.empty(n_scratch, dtype=f, device=dev) if n_scratch else None
    ptr = out.data_ptr()
    rc = lib.kt_score_subsets(*[a.data_ptr() for a in args], X.data_ptr(), M, N, R, Q, T,
                              float(np.float32(pend_npods)), float(np.float32(t.churn_weight)), ptr, ptr + 4 * M,
                              scratch.data_ptr() if scratch is not None else None, build.stream_ptr(dev))
    build.check(rc, "score_subsets")
    build.LAUNCHES["score_subsets"] += 1
    return out


def unpack(packed, M: int):
    """(score [M] f32, feasible [M] bool) views of a packed K6 output
    (a tensor or a numpy array)."""
    if isinstance(packed, np.ndarray):
        return packed[:4 * M].view(np.float32), packed[4 * M:].view(np.bool_)
    return packed[:4 * M].view(torch.float32), packed[4 * M:].view(torch.bool)


def score_subsets(t, onehot, compat_nq, pend_req, pend_npods: float, pend_active, X):
    """t: ConsolidationTensors; onehot / compat_nq [Np, Qp], pend_req [R],
    pend_active [Qp] (f32), pend_npods a float, X [M, Np] bool."""
    if X.device.type == "cpu":
        return objective_factored_plain(t, onehot, compat_nq, pend_req, pend_npods, pend_active, X)
    return unpack(score_subsets_packed(t, onehot, compat_nq, pend_req, pend_npods, pend_active, X), X.shape[0])
