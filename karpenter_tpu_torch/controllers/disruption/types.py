"""Disruption candidates and commands (reference: disruption/types.go:75-283)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ...apis import labels as wk
from ...utils import disruption as disruption_utils
from ...utils import pods as pod_utils

REASON_UNDERUTILIZED = "Underutilized"
REASON_EMPTY = "Empty"
REASON_DRIFTED = "Drifted"


@dataclass
class Candidate:
    """A node eligible for disruption (types.go:75-211)."""

    state_node: object
    node_claim: object
    node_pool: object
    instance_type: Optional[object]
    capacity_type: str
    zone: str
    price: float
    reschedulable_pods: list
    disruption_cost: float
    # 1.0 base + sum of positive pod eviction costs; the numerator/denominator
    # unit of balanced scoring (types.go:85-89 RescheduleDisruptionCost)
    reschedule_disruption_cost: float = 1.0

    def savings_ratio(self) -> float:
        """Cost per unit disruption; higher = prefer to disrupt
        (types.go:144-145)."""
        return self.price / self.reschedule_disruption_cost

    def name(self) -> str:
        return self.state_node.name()

    def owned_by_static_node_pool(self) -> bool:
        """Static fleets are replaced 1:1 by StaticDrift, never consolidated
        (types.go:147)."""
        return self.node_pool is not None and self.node_pool.is_static()


@dataclass
class Command:
    """A validated disruption decision (types.go:227-283)."""

    reason: str = ""
    candidates: list = field(default_factory=list)
    replacements: list = field(default_factory=list)  # SchedulingNodeClaims
    results: object = None

    def decision(self) -> str:
        if not self.candidates:
            return "no-op"
        return "replace" if self.replacements else "delete"

    def candidate_names(self) -> list[str]:
        return [c.name() for c in self.candidates]


def build_candidate(cluster, store, clock, state_node, node_pools_by_name, instance_types_by_pool, pdb_limits, recorder=None) -> tuple[Optional[Candidate], str | None]:
    """Candidate construction with all the disqualification gates
    (types.go:160-211 NewCandidate)."""
    err = state_node.validate_node_disruptable(clock.now())
    if err is not None:
        return None, err
    pool_name = state_node.nodepool_name()
    node_pool = node_pools_by_name.get(pool_name)
    if node_pool is None:
        return None, f"nodepool {pool_name} not found"

    labels = state_node.labels()
    it_name = labels.get(wk.INSTANCE_TYPE_LABEL_KEY, "")
    instance_type = next((it for it in instance_types_by_pool.get(pool_name, []) if it.name == it_name), None)
    capacity_type = labels.get(wk.CAPACITY_TYPE_LABEL_KEY, "")
    zone = labels.get(wk.ZONE_LABEL_KEY, "")
    price = 0.0
    if instance_type is not None:
        p = instance_type.offering_price(zone, capacity_type)
        price = p if p is not None else 0.0

    # the candidate's pod set is every pod still tracked on the node —
    # terminating pods included (types.go:188-199 + statenode.go:244-264
    # ValidatePodsDisruptable reads the live bindings); is_reschedulable
    # below decides which of them reserve replacement capacity
    pods = []
    for key in state_node.pod_requests:
        ns, name = key.split("/", 1)
        pod = store.try_get("Pod", name, ns)
        if pod is not None and not pod_utils.is_terminal(pod):
            pods.append(pod)

    # pods that block disruption; do-not-disrupt only blocks for ACTIVE pods
    # (scheduling.go:115-117 IsDisruptable: a terminating pod cannot hold its
    # node hostage)
    for pod in pods:
        if not pod_utils.is_active(pod):
            continue
        if pod_utils.has_do_not_disrupt(pod, clock.now()) and node_pool.spec.template.termination_grace_period is None:
            return None, f"pod {pod.key()} has do-not-disrupt"
        ok, pdb = pdb_limits.can_evict(pod)
        if not ok and node_pool.spec.template.termination_grace_period is None:
            return None, f"pdb {pdb} prevents pod eviction"

    reschedulable = [p for p in pods if pod_utils.is_reschedulable(p)]
    cost = disruption_utils.rescheduling_cost(reschedulable) * disruption_utils.lifetime_remaining(
        clock.now(),
        state_node.node_claim.spec.expire_after if state_node.node_claim else None,
        state_node.node_claim.metadata.creation_timestamp if state_node.node_claim else clock.now(),
    )
    return (
        Candidate(
            state_node=state_node,
            node_claim=state_node.node_claim,
            node_pool=node_pool,
            instance_type=instance_type,
            capacity_type=capacity_type,
            zone=zone,
            price=price,
            reschedulable_pods=reschedulable,
            disruption_cost=cost,
            reschedule_disruption_cost=1.0
            + sum(max(0.0, disruption_utils.eviction_cost(p)) for p in reschedulable),
        ),
        None,
    )
