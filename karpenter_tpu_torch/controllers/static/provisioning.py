"""Static capacity's claim builder: the template NodeClaim of a replica
NodePool and its node-limit headroom (reference:
static/provisioning/controller.go:109-115, staticdrift.go:92-96).

The port has these two because the disruption controller's StaticDrift
method replaces drifted static nodes with them; the static provisioning and
deprovisioning controllers come with the operator runtime that runs them.
"""

from __future__ import annotations

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
