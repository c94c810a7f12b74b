"""Balanced consolidation scoring.

Reference: disruption/balanced.go:32-185 — a move is approved when, for every
Balanced pool it touches, (savings / pool_total_cost) divided by
(disruption_cost / pool_total_disruption_cost) meets the 1/k threshold.
Totals come from ClusterCost (precomputed) when available; disruption totals
sum over ALL nodes in the pool, not just candidates.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...apis import labels as wk
from ...apis.nodepool import BALANCED, BALANCED_K


@dataclass
class NodePoolTotals:
    total_cost: float = 0.0
    total_disruption_cost: float = 0.0


@dataclass
class ScoreResult:
    """balanced.go / types.go:93-111 — score = savings%/disruption%."""

    savings_fraction: float = 0.0
    disruption_fraction: float = 0.0
    k: int = BALANCED_K

    def score(self) -> float:
        if self.savings_fraction <= 0:
            return 0.0
        if self.disruption_fraction == 0:
            return float("inf")
        return self.savings_fraction / self.disruption_fraction

    def threshold(self) -> float:
        return 1.0 / self.k

    def approved(self) -> bool:
        return self.score() >= self.threshold()


def score_move(savings: float, disruption_cost: float, totals: NodePoolTotals, k: int = BALANCED_K) -> ScoreResult:
    """ScoreMove (balanced.go:106-124). Zero totals → nothing to normalise
    against → not approved."""
    if totals.total_cost <= 0 or totals.total_disruption_cost <= 0:
        return ScoreResult(k=k)
    return ScoreResult(
        savings_fraction=savings / totals.total_cost,
        disruption_fraction=disruption_cost / totals.total_disruption_cost,
        k=k,
    )


def compute_node_pool_totals(all_candidates, all_nodes, cluster_cost) -> dict[str, NodePoolTotals]:
    """computeNodePoolTotals (balanced.go:47-101): cost from ClusterCost with
    candidate-price fallback; disruption from every node in the pool — the
    accurate reschedule cost for candidates, the incrementally-maintained
    StateNode cost (plus the 1.0 per-node base) for the rest."""
    candidate_by_name = {c.name(): c for c in all_candidates}
    totals: dict[str, NodePoolTotals] = {}
    for c in all_candidates:
        t = totals.setdefault(c.node_pool.metadata.name, NodePoolTotals())
        t.total_cost += c.price  # fallback; replaced below when ClusterCost knows better
    for n in all_nodes:
        pool = n.labels().get(wk.NODEPOOL_LABEL_KEY)
        if pool is None or pool not in totals:
            continue
        c = candidate_by_name.get(n.name())
        if c is not None:
            totals[pool].total_disruption_cost += c.reschedule_disruption_cost
        else:
            totals[pool].total_disruption_cost += n.disruption_cost()
    if cluster_cost is not None:
        for pool, t in totals.items():
            cc = cluster_cost.get_nodepool_cost(pool)
            if cc > 0:
                t.total_cost = cc
    return totals


def evaluate_balanced_move(command, replacement_price: float, node_pool_totals: dict[str, NodePoolTotals]) -> bool:
    """EvaluateBalancedMove (balanced.go:131-182): each Balanced pool scores
    independently; approval requires every Balanced pool to approve.
    Cross-pool savings are attributed proportionally to source cost."""
    if not command.candidates:
        return False
    by_pool: dict[str, list] = {}
    for c in command.candidates:
        by_pool.setdefault(c.node_pool.metadata.name, []).append(c)
    source_cost = sum(c.price for c in command.candidates)
    savings = source_cost - replacement_price
    for pool, pool_candidates in by_pool.items():
        node_pool = pool_candidates[0].node_pool
        if node_pool.spec.disruption.consolidation_policy != BALANCED:
            continue
        disruption_cost = sum(c.reschedule_disruption_cost for c in pool_candidates)
        pool_savings = savings
        if source_cost > 0 and len(by_pool) > 1:
            pool_savings = savings * (sum(c.price for c in pool_candidates) / source_cost)
        result = score_move(pool_savings, disruption_cost, node_pool_totals.get(pool, NodePoolTotals()))
        if not result.approved():
            return False
    return True
