"""Multi-node consolidation tensors, the discrete objective and the
annealed subset search (plain PyTorch versions and kernel entry points).

Counterpart of the reference's `models/consolidation_model.py`:
`ConsolidationTensors`, `_objective` (here `objective_plain`, batched over a
leading axis of delete-sets), `anneal_chains` / `anneal` (kernel K7), and the
zero-pending delegations `lp_repack` / `score_subsets` into
`models/globalpack.py` (kernels K5 and K6).

The random streams of the search are tensors handed in (`x0`, `flips`,
`u`); `anneal` draws the reference's own for a seed (`utils.prng`, bit
for bit `jax.random`'s).

The discrete objectives add in the reference's own order (`xla_sum`:
XLA:CPU rewrites a sum over an axis longer than 32 into windows of 32
consecutive float32 terms, each added in order, then sums the window sums
the same way) and round `savings - churn_weight * cost` once, as XLA's
fused multiply-add does: scores, and so the ranking of delete-sets, are
bit-identical to the reference's. Kernels K6 and K7 add in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BIG = 3.4e38  # rounds to float32 3.4e38, the reference's BIG
CHURN_WEIGHT = 1e-4


@dataclass
class ConsolidationTensors:
    """Device inputs of one consolidation search (node axis padded to Np,
    replacement rows to Tp)."""

    node_price: torch.Tensor  # [Np] f32 price of each candidate node
    node_cost: torch.Tensor  # [Np] f32 disruption (churn) cost
    node_slack: torch.Tensor  # [Np, R] f32 free allocatable if kept
    node_used: torch.Tensor  # [Np, R] f32 requests of its reschedulable pods
    node_npods: torch.Tensor  # [Np] f32 reschedulable pod count
    pod_compat: torch.Tensor  # [Np, Np] f32 0/1 [j host, i deleted] (dense form), else [1, 1]
    row_alloc: torch.Tensor  # [Tp, R] f32 allocatable of replacement rows
    row_price: torch.Tensor  # [Tp] f32 price of replacement rows
    churn_weight: float = CHURN_WEIGHT


def dsum(x: torch.Tensor, dim) -> torch.Tensor:
    """Sum in float64, rounded to float32 once."""
    return x.double().sum(dim).float()


XLA_WINDOW = 32


def xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Float32 sum over `dim` in XLA:CPU's order: while more than 32 terms
    remain, windows of 32 consecutive terms are each added in order from 0;
    the last (at most 32) terms are added in order from 0. The axis length
    must then be a multiple of 32 at each level (the padded node and row
    axes are powers of two)."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > XLA_WINDOW:
        n = x.shape[-1]
        if n % XLA_WINDOW:
            raise ValueError(f"xla_sum: axis of {n} terms is not a multiple of {XLA_WINDOW}")
        x = _ordered_sum(x.reshape(*x.shape[:-1], n // XLA_WINDOW, XLA_WINDOW))
    return _ordered_sum(x)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def fma_score(savings, weight: float, cost):
    """savings - weight * cost with one rounding (XLA contracts it into a
    fused multiply-add): exact in float64 for float32 operands of these
    magnitudes, then rounded once."""
    w = torch.tensor(weight, dtype=torch.float32).double()
    return (savings.double() - w * cost.double()).float()


def replacement_cost(t: ConsolidationTensors, shortfall: torch.Tensor, multi: torch.Tensor):
    """Cheapest replacement for each shortfall [M, R]: with `multi` [M] (pending
    pods present) the ceil count of identical row-t nodes covering it, else
    the single row covering all of it. Returns best_row_cost [M] f32."""
    big = torch.tensor(BIG, dtype=torch.float32, device=shortfall.device)
    alloc = t.row_alloc.unsqueeze(0)  # [1, T, R]
    sf = shortfall.unsqueeze(1)  # [M, 1, R]
    row_fits = (alloc >= sf).all(dim=2)
    single = torch.where(row_fits, t.row_price, big)
    row_ok = ((alloc > 0) | (sf <= 0)).all(dim=2)
    ratio = sf / torch.clamp(alloc, min=1e-9)
    count = torch.ceil(torch.where(sf > 0, ratio, torch.zeros((), device=sf.device)).amax(dim=2))
    multi_cost = torch.where(row_ok, t.row_price * torch.clamp(count, min=1.0), big)
    row_cost = torch.where(multi.unsqueeze(1), multi_cost, single)
    return row_cost.amin(dim=1)


def finish_score(t: ConsolidationTensors, xf, displaced, usable, best_row_cost):
    """(score [M], feasible [M]) from the displaced mass, the usable slack and
    the best replacement row: the reference's tail of `_objective`."""
    big = torch.tensor(BIG, dtype=torch.float32, device=xf.device)
    zero = torch.zeros((), device=xf.device)
    shortfall = torch.clamp(displaced - usable, min=0.0)
    needs = (shortfall > 0).any(dim=1)
    replacement = torch.where(needs, best_row_cost, zero)
    feasible = ~needs | (best_row_cost < big)
    savings = xla_sum(t.node_price * xf, 1) - replacement
    score = fma_score(savings, t.churn_weight, xla_sum(t.node_cost * xf, 1))
    return torch.where(feasible, score, -big), feasible


def objective_plain(t: ConsolidationTensors, X: torch.Tensor):
    """The reference's `_objective` for each delete-set X [M, Np] bool:
    (score [M] f32, feasible [M] bool). `pod_compat` must be the dense 0/1
    [Np, Np] form: compat_to_any_deleted[j] = max_i pod_compat[j, i] x[i] is
    then (pod_compat @ x)[j] > 0."""
    xf = X.float()
    keep = 1.0 - xf
    displaced = xla_sum(xf.unsqueeze(2) * t.node_used, 1)  # [M, R]
    n_displaced = torch.clamp(xla_sum(t.node_npods * xf, 1), min=1.0)
    avg_pod = displaced / n_displaced.unsqueeze(1)
    compat_any = ((xf.double() @ t.pod_compat.double().T) > 0).float()  # [M, Np]
    can_host = (t.node_slack.unsqueeze(0) >= avg_pod.unsqueeze(1)).all(dim=2).float()
    usable = xla_sum((keep * compat_any * can_host).unsqueeze(2) * t.node_slack, 1)
    shortfall = torch.clamp(displaced - usable, min=0.0)
    no_pending = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
    return finish_score(t, xf, displaced, usable, replacement_cost(t, shortfall, no_pending))


def anneal_chains(t: ConsolidationTensors, x0, flips, u, n_steps: int | None = None):
    """The reference's `anneal_chains` with explicit random streams: x0 [C, Np]
    bool starts, flips [C, S] int32 node per step, u [C, S] f32 uniforms.
    Returns (best_x [C, Np] bool, best_s [C] f32). Kernel K7 on CUDA tensors."""
    from ..kernels.anneal import anneal as k7

    S = int(flips.shape[1]) if n_steps is None else int(n_steps)
    return k7(t, x0, flips[:, :S].contiguous(), u[:, :S].contiguous())


def draw_anneal_streams(n: int, seed: int, device, n_chains: int = 64, n_steps: int = 512):
    """The reference's streams for `seed` (`utils.prng.anneal_streams`, bit
    for bit `jax.random`'s): x0 = U < 0.3 [C, n], flips ~ randint(0, n)
    [C, S], u ~ U(0, 1) [C, S], drawn on the host and moved to `device`."""
    from ..utils.prng import anneal_streams

    return tuple(torch.from_numpy(a).to(device) for a in anneal_streams(seed, n_chains, n_steps, n))


def anneal(t: ConsolidationTensors, seed: int, n_chains: int = 64, n_steps: int = 512):
    """Parallel annealing chains from the reference's draws for `seed`."""
    x0, flips, u = draw_anneal_streams(t.node_price.shape[0], seed, t.node_price.device, n_chains, n_steps)
    return anneal_chains(t, x0, flips, u)


def lp_repack(t: ConsolidationTensors, onehot, compat_qn, d0, y0, n_iters: int = 300):
    """The consolidation-only relaxed repack: `global_repack` at zero pending
    mass and unit unplaced weights. Returns (d [C, Np], score [C])."""
    from .globalpack import global_repack, zero_pending

    pend_mass, pend_weight = zero_pending(onehot.shape[1], t.node_used.shape[1], onehot.device)
    return global_repack(t, onehot, compat_qn, pend_mass, pend_weight, d0, y0, n_iters=n_iters)


def score_subsets(t: ConsolidationTensors, onehot, compat_nq, X, stage=None):
    """Score delete-sets X [M, Np] with no pending pods (host numpy out);
    `stage` as `score_subsets_global`'s."""
    from .globalpack import score_subsets_global

    R, Q = t.node_used.shape[1], onehot.shape[1]
    dev = onehot.device
    pend_req = torch.zeros(R, dtype=torch.float32, device=dev)
    pend_active = torch.zeros(Q, dtype=torch.float32, device=dev)
    return score_subsets_global(t, onehot, compat_nq, pend_req, 0.0, pend_active, X, stage)
