"""Static scale-up: keep each replica NodePool at its desired NodeClaim count.

Reference: static/provisioning/controller.go:75-123 — count the pool's live
NodeClaims, and when below spec.replicas create the difference directly from
the NodeClaim template (no pod-driven scheduling), capped by the pool's node
limit. Scale-down is the deprovisioning controller's job.
"""

from __future__ import annotations

from ...apis import labels as wk
from ...apis.nodepool import COND_NODEPOOL_READY
from ..provisioning.scheduling.nodeclaim import NodeClaimTemplate, SchedulingNodeClaim


class _NullTopology:
    """SchedulingNodeClaim registers its hostname with the solve topology;
    a static claim has no solve, so registration is a no-op."""

    def register(self, key, value):
        pass


def build_static_claim(np, instance_types) -> SchedulingNodeClaim:
    """A pod-less NodeClaim straight from the pool template — how static
    fleets and their drift replacements are built (static/provisioning
    controller.go:109-115, staticdrift.go:92-96)."""
    template = NodeClaimTemplate(np)
    template.instance_type_options = instance_types
    claim = SchedulingNodeClaim(template, _NullTopology(), [], instance_types)
    claim.finalize()
    return claim


def node_limit_headroom(np, live: int) -> int:
    """How many more nodes the pool's limits.nodes allows; unbounded pools
    report a large sentinel."""
    if np.spec.limits and "nodes" in np.spec.limits:
        return max(0, int(np.spec.limits["nodes"].value) - live)
    return 1 << 30


class StaticProvisioningController:
    def __init__(self, store, cluster, cloud_provider, provisioner, clock, metrics=None):
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.provisioner = provisioner
        self.clock = clock
        self.metrics = metrics

    def reconcile(self) -> None:
        for np in self.store.list("NodePool"):
            if not np.is_static() or np.metadata.deletion_timestamp is not None:
                continue
            if np.status.conditions.is_false(COND_NODEPOOL_READY):
                continue
            self._reconcile_pool(np)

    def _reconcile_pool(self, np) -> None:
        running = self._live_claim_count(np.metadata.name)
        desired = np.spec.replicas or 0
        if running >= desired:
            return
        # node-count limit caps the fleet (controller.go:97-104)
        to_create = min(desired - running, node_limit_headroom(np, running))
        if to_create <= 0:
            return
        its = self.cloud_provider.get_instance_types(np)
        if not its:
            return
        for _ in range(to_create):
            claim = build_static_claim(np, its)
            if self.provisioner.create_node_claim(claim, reason="static_provisioned") is None:
                return

    def _live_claim_count(self, pool: str) -> int:
        return sum(
            1
            for nc in self.store.list("NodeClaim")
            if nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY) == pool and nc.metadata.deletion_timestamp is None
        )
