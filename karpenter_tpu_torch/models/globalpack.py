"""globalpack: the relaxed global repack and the factored subset scorer
(plain PyTorch versions and kernel entry points).

Counterpart of the reference's `models/globalpack.py`. Decision variables,
per random init c: fractional deletion d [Np], routing y [Qp, Np] of each
class's mass onto surviving nodes and yr [Qp, Tp] onto replacement rows.
`global_repack` runs projected Adam ascent on `gp_objective_plain` from
explicit inits (kernel K5); the gradient is written out by hand
(`gp_grad_plain`) and follows JAX's rules where the objective is not smooth:
d max(x, 0)/dx is 0.5 at x == 0, and a max over an axis splits its gradient
equally among tied maxima. `score_subsets_global` scores rounded
delete-sets with the discrete factored objective (kernel K6);
`rank_ladder` is the reference's host ladder, copied.

Reductions accumulate in float64 and round to float32 once; elementwise
arithmetic is float32 in the reference's order. The kernels follow the same
rule.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from .consolidation_model import ConsolidationTensors, dsum, finish_score, replacement_cost, xla_sum

PRICE_CAP = 1e6  # replacement-row prices clamp to this inside the relaxation
PENDING_WEIGHT = 100.0  # unplaced-mass hinge weight of pending classes
LP_SCORE_BATCH = 32  # delete-set rows are scored in multiples of this
# Adam: b1, b2, lr, eps, and 1 - b1, 1 - b2 as the reference forms them
# (Python doubles rounded to float32)
ADAM = dict(b1=np.float32(0.9), b2=np.float32(0.999), lr=np.float32(0.05), eps=np.float32(1e-8),
            c1=np.float32(1 - 0.9), c2=np.float32(1 - 0.999))


def adam_corrections(n_iters: int) -> np.ndarray:
    """[n_iters, 2] f32 (1 - b1**it, 1 - b2**it) for it = 1..n_iters, as the
    reference's XLA:CPU evaluates them (a probe of 2000 steps: float32 of
    the float64 power, then 1 - x in float32)."""
    it = np.arange(1, n_iters + 1, dtype=np.float64)
    one = np.float32(1.0)
    return np.stack([one - (np.float64(ADAM["b1"]) ** it).astype(np.float32),
                     one - (np.float64(ADAM["b2"]) ** it).astype(np.float32)], axis=1)


def gp_normalisers(t: ConsolidationTensors, pend_mass):
    """(price_safe [T], inv_alloc [T, R], norm_r [R]), computed once per solve."""
    cap = torch.tensor(PRICE_CAP, dtype=torch.float32, device=t.row_price.device)
    price_safe = torch.minimum(t.row_price, cap)
    inv_alloc = torch.where(t.row_alloc > 0, torch.reciprocal(torch.clamp(t.row_alloc, min=1e-9)), cap)
    scale_r = torch.maximum(torch.clamp(t.node_used.amax(dim=0), min=0.0), torch.clamp(t.node_slack.amax(dim=0), min=0.0))
    scale_r = torch.maximum(scale_r, torch.clamp(pend_mass.amax(dim=0), min=0.0))
    norm_r = torch.reciprocal(torch.clamp(scale_r, min=1e-9))
    return price_safe, inv_alloc, norm_r


def _bal(x):
    """JAX's derivative of max(x, 0): 1 above, 0.5 at the tie, 0 below."""
    return torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0)).to(x.dtype)


def _forward(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr, inv_alloc, norm_r, price_safe):
    """The objective's pieces for d [C, N], y [C, Q, N], yr [C, Q, T]."""
    f = {}
    f["keep"] = 1.0 - d
    od = onehot.unsqueeze(0) * d.unsqueeze(2)  # [C, N, Q]
    f["disp"] = pend_mass + torch.einsum("cnq,nr->cqr", od.double(), t.node_used.double()).float()
    yc = y * compat_qn
    f["yc"] = yc
    routed = torch.einsum("cqn,cqr->cnr", yc.double(), f["disp"].double()).float()
    f["a"] = routed - f["keep"].unsqueeze(2) * t.node_slack
    f["over"] = torch.clamp(f["a"], min=0.0) * norm_r
    rep = torch.einsum("cqt,cqr->ctr", yr.double(), f["disp"].double()).float()
    f["w"] = rep * inv_alloc
    f["z"] = f["w"].amax(dim=2)
    f["route_total"] = dsum(yc, 2) + dsum(yr, 2)
    f["class_mass"] = dsum(f["disp"] * norm_r, 2)
    f["u"] = 1.0 - f["route_total"]
    f["h"] = torch.clamp(f["u"], min=0.0)
    return f


def gp_objective_plain(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr, inv_alloc, norm_r, price_safe):
    """The relaxed global-repack objective (maximised), per init: [C] f32."""
    f = _forward(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr, inv_alloc, norm_r, price_safe)
    cap_pen = dsum(f["over"] * f["over"], (1, 2))
    rep_cost = dsum(price_safe * f["z"], 1)
    unrouted = dsum(f["h"] * f["class_mass"] * pend_weight, 1)
    cw = torch.tensor(t.churn_weight, dtype=torch.float32)
    savings = dsum(d * t.node_price, 1) - cw * dsum(d * t.node_cost, 1)
    return savings - rep_cost - 10.0 * cap_pen - 10.0 * unrouted


def gp_grad_plain(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr, inv_alloc, norm_r, price_safe):
    """Gradient of the NEGATED objective with respect to (d, y, yr), the
    reference's `jax.grad` written out: (gd [C, N], gy [C, Q, N], gyr [C, Q, T])."""
    f = _forward(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr, inv_alloc, norm_r, price_safe)
    # 10 * sum(over^2): d/d(over) = 20 over; over = max(a, 0) * norm_r
    g_a = (20.0 * f["over"]) * norm_r * _bal(f["a"])  # [C, N, R] = dL/d(routed)
    # price_safe . max_r(w): the max's gradient split equally among ties
    ind = (f["w"] == f["z"].unsqueeze(2)).float()
    g_w = (price_safe.unsqueeze(1) * ind) / ind.sum(dim=2, keepdim=True)
    g_rep = g_w * inv_alloc  # [C, T, R]
    # 10 * sum_q max(1 - route_total, 0) * class_mass * weight
    g_hcm = 10.0 * pend_weight
    g_h = g_hcm * f["class_mass"]
    g_cm = g_hcm * f["h"]
    g_rt = -(g_h * _bal(f["u"]))  # [C, Q]
    D = torch.float64
    g_disp = (torch.einsum("cqn,cnr->cqr", f["yc"].double(), g_a.double())
              + torch.einsum("cqt,ctr->cqr", yr.double(), g_rep.double())
              + (g_cm.unsqueeze(2) * norm_r).double()).float()  # [C, Q, R]
    g_yc = (torch.einsum("cnr,cqr->cqn", g_a.double(), f["disp"].double()) + g_rt.double().unsqueeze(2)).float()
    gy = g_yc * compat_qn
    gyr = (torch.einsum("ctr,cqr->cqt", g_rep.double(), f["disp"].double()) + g_rt.double().unsqueeze(2)).float()
    cw = torch.tensor(t.churn_weight, dtype=torch.float32)
    per_class = torch.einsum("nr,cqr->cnq", t.node_used.to(D), g_disp.to(D))  # [C, N, Q]
    gd = ((g_a.to(D) * t.node_slack.to(D)).sum(2) + (onehot.to(D).unsqueeze(0) * per_class).sum(2)
          - t.node_price.to(D) + (cw * t.node_cost).to(D)).float()
    return gd, gy, gyr


def gp_project(y, yr, compat_qn):
    """Project routing rows back onto {>= 0, compat-masked, sum == 1}."""
    y = torch.clamp(y, min=0.0) * compat_qn
    yr = torch.clamp(yr, min=0.0)
    s = dsum(y, -1) + dsum(yr, -1)
    scale = torch.reciprocal(torch.clamp(s, min=1e-9)).unsqueeze(-1)
    return y * scale, yr * scale


def draw_gp_inits(n_inits: int, N: int, Q: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's random starts for `seed` (`utils.prng.lp_inits`, bit
    for bit `jax.random`'s): d0 ~ U(0.05, 0.95) [C, N] and y0 ~ U(0.1, 1.0)
    [C, Q, N], drawn on the host and moved to `device`."""
    from ..utils.prng import lp_inits

    d0, y0 = lp_inits(seed, n_inits, N, Q)
    return torch.from_numpy(d0).to(device), torch.from_numpy(y0).to(device)


def global_repack(t: ConsolidationTensors, onehot, compat_qn, pend_mass, pend_weight, d0, y0, n_iters: int = 300):
    """Projected Adam ascent from the inits d0 [C, Np], y0 [C, Qp, Np]
    (yr starts at 0.5 before the first projection). Returns (d [C, Np],
    score [C]). Kernel K5 on CUDA tensors."""
    from ..kernels.globalpack import globalpack

    return globalpack(t, onehot, compat_qn, pend_mass, pend_weight, d0, y0, n_iters)


def zero_pending(n_classes: int, n_resources: int, device):
    """The consolidation-only point: no pending mass, unit unplaced weights."""
    return (torch.zeros((n_classes, n_resources), dtype=torch.float32, device=device),
            torch.ones(n_classes, dtype=torch.float32, device=device))


def objective_factored_plain(t: ConsolidationTensors, onehot, compat_nq, pend_req, pend_npods: float, pend_active, X):
    """The reference's `_objective_factored` for each delete-set X [M, Np]:
    (score [M] f32, feasible [M] bool); the pending mass is folded into the
    displaced side."""
    xf = X.float()
    keep = 1.0 - xf
    displaced = pend_req + xla_sum(xf.unsqueeze(2) * t.node_used, 1)  # [M, R]
    npods = torch.tensor(np.float32(pend_npods), device=xf.device)
    n_displaced = torch.clamp(npods + xla_sum(t.node_npods * xf, 1), min=1.0)
    avg_pod = displaced / n_displaced.unsqueeze(1)
    deleted_class = torch.maximum((onehot.unsqueeze(0) * xf.unsqueeze(2)).amax(dim=1), pend_active)  # [M, Q]
    compat_any = (compat_nq.unsqueeze(0) * deleted_class.unsqueeze(1)).amax(dim=2)  # [M, N]
    can_host = (t.node_slack.unsqueeze(0) >= avg_pod.unsqueeze(1)).all(dim=2).float()
    usable = xla_sum((keep * compat_any * can_host).unsqueeze(2) * t.node_slack, 1)
    shortfall = torch.clamp(displaced - usable, min=0.0)
    multi = torch.full((X.shape[0],), pend_npods > 0, dtype=torch.bool, device=X.device)
    return finish_score(t, xf, displaced, usable, replacement_cost(t, shortfall, multi))


def score_subsets_global(t: ConsolidationTensors, onehot, compat_nq, pend_req, pend_npods: float, pend_active, X,
                         stage=None):
    """Score delete-sets X [M, Np] (numpy or tensor, bool) against a fixed
    pending load: pads the rows to a multiple of LP_SCORE_BATCH with
    all-False rows, as the reference does, and scores them in one kernel K6
    launch: one upload of the rows, one download of the scores and flags
    together. Returns numpy (scores [M] f32, feasible [M] bool). `stage`
    (a context-manager factory, e.g. the proposers' stage timer) brackets
    the upload, the kernel and the download."""
    from ..kernels.score_subsets import score_subsets_packed, unpack

    stage = stage or (lambda _name: nullcontext())
    X = np.asarray(X, dtype=bool)
    m = X.shape[0]
    Xp = np.zeros((m + (-m % LP_SCORE_BATCH), X.shape[1]), dtype=bool)
    Xp[:m] = X
    with stage("K6 upload"):
        Xt = torch.from_numpy(Xp).to(onehot.device)
    with stage("K6 kernel"):
        packed = score_subsets_packed(t, onehot, compat_nq, pend_req, pend_npods, pend_active, Xt)
    with stage("K6 download"):
        host = packed.cpu().numpy()
    s, f = unpack(host, Xp.shape[0])
    return s[:m], f[:m]


def rank_ladder(scores, feas, X, n, max_proposals, floor=0.0, skip_rows=frozenset()):
    """Best-first deduped delete-set ladder from one scored rounding batch
    (the reference's `rank_ladder`, copied): rows by descending score,
    feasible and strictly above `floor`, deduped on the real-candidate
    member set, at most `max_proposals`. Returns (ladder [(subset, score)],
    best = max(floor, top score))."""
    out: list[tuple[list[int], float]] = []
    emitted: set[tuple] = set()
    best = float(floor)
    for i in np.argsort(-scores):
        if int(i) in skip_rows or scores[i] <= floor or not feas[i]:
            continue
        subset = tuple(np.nonzero(X[i][:n])[0].tolist())
        if not subset or subset in emitted:
            continue
        emitted.add(subset)
        out.append((list(subset), float(scores[i])))
        best = max(best, float(scores[i]))
        if len(out) >= max_proposals:
            break
    return out, best
