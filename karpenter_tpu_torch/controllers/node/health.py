"""Node health/repair controller (NodeRepair feature gate).

Reference: pkg/controllers/node/health/controller.go:64-155 — nodes whose
conditions match a CloudProvider RepairPolicy for longer than the policy's
toleration window are force-repaired by deleting their NodeClaim, with the
termination-grace-period annotation stamped so the drain cannot wedge.
Repair is vetoed while >20% of the pool's (or cluster's, for standalone
claims) nodes are unhealthy — mass-outage protection.
"""

from __future__ import annotations

import math

from ...apis import labels as wk
from ...utils import pods as pod_utils

ALLOWED_UNHEALTHY_PERCENT = 20


class HealthController:
    def __init__(self, store, cluster, cloud_provider, clock, recorder=None, metrics=None, enabled=True):
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        self.metrics = metrics
        self.enabled = enabled

    def reconcile(self) -> None:
        if not self.enabled:
            return
        policies = self.cloud_provider.repair_policies()
        if not policies:
            return
        nodes = self.store.list("Node")
        claims_by_provider = {c.status.provider_id: c for c in self.store.list("NodeClaim") if c.status.provider_id}
        # one pass over conditions; the veto math below reuses this set
        unhealthy = {n.metadata.name: self._find_unhealthy(n, policies) for n in nodes}
        unhealthy = {name: v for name, v in unhealthy.items() if v[0] is not None}
        for node in nodes:
            nc = claims_by_provider.get(node.spec.provider_id)
            if nc is None or nc.metadata.deletion_timestamp is not None:
                continue
            cond, toleration = unhealthy.get(node.metadata.name, (None, 0.0))
            if cond is None:
                continue
            if self.clock.now() < cond.last_transition_time + toleration:
                continue  # not yet past the toleration window
            pool_name = nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)
            if not self._healthy_enough(nodes, unhealthy, pool_name):
                if self.recorder is not None:
                    scope = f"nodepool {pool_name}" if pool_name else "cluster"
                    self.recorder.publish(
                        node,
                        "NodeRepairBlocked",
                        f"more than {ALLOWED_UNHEALTHY_PERCENT}% of nodes in the {scope} are unhealthy",
                        type_="Warning",
                    )
                continue
            self._repair(node, nc, cond)

    @staticmethod
    def _find_unhealthy(node, policies):
        """First node condition matching a repair policy (controller.go
        findUnhealthyConditions)."""
        for policy in policies:
            for cond in node.status.conditions:
                if cond.type == policy.condition_type and cond.status == policy.condition_status:
                    return cond, policy.toleration_duration
        return None, 0.0

    @staticmethod
    def _healthy_enough(nodes, unhealthy: dict, pool_name: str | None) -> bool:
        """<=20% (ceil) of the pool's nodes may be unhealthy for repair to
        proceed (controller.go:236-263)."""
        scope = [
            n
            for n in nodes
            if pool_name is None or n.metadata.labels.get(wk.NODEPOOL_LABEL_KEY) == pool_name
        ]
        count = sum(1 for n in scope if n.metadata.name in unhealthy)
        threshold = math.ceil(ALLOWED_UNHEALTHY_PERCENT * len(scope) / 100)
        return count <= threshold

    def _repair(self, node, nc, cond) -> None:
        # force-drain via the termination-grace-period annotation: an already-
        # expired deadline lets the terminator bypass blocked PDBs/do-not-disrupt
        deadline = self.clock.now()

        def stamp(obj):
            obj.metadata.annotations[wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY] = str(deadline)

        self.store.patch("NodeClaim", nc.metadata.name, stamp)
        self.store.patch("Node", node.metadata.name, stamp)
        self.store.try_delete("NodeClaim", nc.metadata.name)
        if self.recorder is not None:
            self.recorder.publish(
                node, "NodeRepair", f"repairing node: condition {cond.type}={cond.status} past toleration"
            )
        if self.metrics is not None:
            from ... import metrics as m

            labels = dict(
                reason="unhealthy",
                nodepool=node.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
                capacity_type=node.metadata.labels.get(wk.CAPACITY_TYPE_LABEL_KEY, ""),
            )
            self.metrics.counter(m.NODECLAIMS_DISRUPTED_TOTAL).inc(**labels)
            reschedulable = [
                p
                for p in self.store.list("Pod")
                if p.spec.node_name == node.metadata.name and pod_utils.is_reschedulable(p)
            ]
            self.metrics.counter(m.PODS_DISRUPTION_INITIATED_TOTAL).inc(len(reschedulable), **labels)
