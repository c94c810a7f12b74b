"""KWOK cloud provider: the in-tree fake cloud used for benchmarks and e2e.

Creates real Node objects in the kube store (no kubelet), mirroring
kwok/cloudprovider/cloudprovider.go:59-174: Create resolves the cheapest
available offering compatible with the NodeClaim's requirements, stamps
instance/offering labels onto the Node, and registers it after the node
class's registration delay.
"""

from __future__ import annotations

import random

from ..apis import labels as wk
from ..apis.nodeclaim import NodeClaim
from ..kube.objects import Node, NodeSpec, NodeStatus, ObjectMeta
from ..scheduling.requirements import Operator, Requirements
from ..scheduling.taints import NO_EXECUTE, Taint
from ..utils import resources as res
from .errors import InsufficientCapacityError, NodeClaimNotFoundError, NodeClassNotReadyError
from .types import InstanceType, RepairPolicy

KWOK_PROVIDER_PREFIX = "kwok://"
UNREGISTERED_TAINT = Taint(key=wk.UNREGISTERED_TAINT_KEY, effect=NO_EXECUTE)


class KWOKCloudProvider:
    """CloudProvider SPI implementation backed by the in-memory kube store."""

    def __init__(self, store, instance_types: list[InstanceType], clock=None, seed: int = 0):
        self.store = store
        self.instance_types = instance_types
        self._by_name = {it.name: it for it in instance_types}
        self.clock = clock
        self._rng = random.Random(seed)
        # Nodes whose registration delay has not elapsed yet: [(ready_at, node)]
        self._pending_nodes: list[tuple[float, Node]] = []

    # -- SPI -------------------------------------------------------------------
    def create(self, node_claim: NodeClaim) -> NodeClaim:
        node = self._to_node(node_claim)
        node_class = self.store.try_get("KWOKNodeClass", node_claim.spec.node_class_ref.name)
        if node_class is None:
            raise InsufficientCapacityError(f"resolving node class {node_claim.spec.node_class_ref.name}")
        if node_class.status.conditions.is_false("Ready"):
            raise NodeClassNotReadyError("node class not ready")
        delay = node_class.spec.node_registration_delay
        if delay > 0 and self.clock is not None:
            self._pending_nodes.append((self.clock.now() + delay, node))
        else:
            self.store.create(node)
        return self._to_node_claim(node)

    def flush_pending(self) -> int:
        """Register nodes whose delay elapsed (the reference leaks a goroutine;
        we advance deterministically with the clock)."""
        if self.clock is None:
            return 0
        now = self.clock.now()
        due = [n for t, n in self._pending_nodes if t <= now]
        self._pending_nodes = [(t, n) for t, n in self._pending_nodes if t > now]
        for node in due:
            self.store.create(node)
        return len(due)

    def delete(self, node_claim: NodeClaim) -> None:
        name = node_claim.status.provider_id.removeprefix(KWOK_PROVIDER_PREFIX)
        if not name or self.store.try_get("Node", name) is None:
            raise NodeClaimNotFoundError(f"instance {node_claim.status.provider_id} not found")
        self.store.delete("Node", name, grace=False)

    def get(self, provider_id: str) -> NodeClaim:
        name = provider_id.removeprefix(KWOK_PROVIDER_PREFIX)
        node = self.store.try_get("Node", name)
        if node is None or node.metadata.deletion_timestamp is not None:
            raise NodeClaimNotFoundError(f"instance {provider_id} not found")
        return self._to_node_claim(node)

    def list(self) -> list[NodeClaim]:
        out = []
        for node in self.store.list("Node"):
            if node.spec.provider_id.startswith(KWOK_PROVIDER_PREFIX):
                out.append(self._to_node_claim(node))
        return out

    def get_instance_types(self, node_pool=None) -> list[InstanceType]:
        return self.instance_types

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return ""

    def repair_policies(self) -> list[RepairPolicy]:
        return [
            RepairPolicy("Ready", "False", 10 * 60),
            RepairPolicy("Ready", "Unknown", 10 * 60),
        ]

    def name(self) -> str:
        return "kwok"

    def get_supported_node_classes(self) -> list[str]:
        return ["KWOKNodeClass"]

    def _reservation_used(self, rid: str) -> int:
        """Live nodes (including registration-pending ones) holding this
        reservation id."""
        n = sum(1 for node in self.store.list("Node") if node.metadata.labels.get(wk.RESERVATION_ID_LABEL_KEY) == rid)
        n += sum(1 for _, node in self._pending_nodes if node.metadata.labels.get(wk.RESERVATION_ID_LABEL_KEY) == rid)
        return n

    # -- conversion ------------------------------------------------------------
    def _to_node(self, node_claim: NodeClaim) -> Node:
        reqs = Requirements.from_node_selector_terms(node_claim.spec.requirements)
        it_req = next((r for r in node_claim.spec.requirements if r["key"] == wk.INSTANCE_TYPE_LABEL_KEY), None)
        if it_req is None:
            raise InsufficientCapacityError("instance type requirement not found")

        best_it, best_offering = None, None
        for val in it_req["values"]:
            it = self._by_name.get(val)
            if it is None:
                raise InsufficientCapacityError(f"instance type {val} not found")
            for o in it.offerings:
                if not o.available or reqs.intersects(o.requirements) is not None:
                    continue
                # launch-side reservation enforcement (the real providers do
                # this in their fleet APIs): a reserved offering whose
                # reservation is fully consumed by live nodes is not launchable
                if o.capacity_type() == wk.CAPACITY_TYPE_RESERVED and self._reservation_used(o.reservation_id()) >= o.reservation_capacity:
                    continue
                if best_offering is None or o.price < best_offering.price:
                    best_it, best_offering = it, o
        if best_offering is None:
            raise InsufficientCapacityError("no available offering satisfies requirements")

        name = f"kwok-{node_claim.metadata.name}-{self._rng.randrange(1 << 32):08x}"
        labels = dict(node_claim.metadata.labels)
        for r in node_claim.spec.requirements:
            if r["operator"] == "In" and len(r.get("values", ())) == 1:
                labels[r["key"]] = r["values"][0]
        labels[wk.INSTANCE_TYPE_LABEL_KEY] = best_it.name
        for source in (best_it.requirements, best_offering.requirements):
            for key, r in source.items():
                if r.operator() == Operator.IN and len(r.values) == 1:
                    labels[key] = r.any()
        labels[wk.HOSTNAME_LABEL_KEY] = name
        labels["kwok.x-k8s.io/node"] = "fake"

        return Node(
            metadata=ObjectMeta(
                name=name,
                labels=labels,
                annotations={**node_claim.metadata.annotations, "kwok.x-k8s.io/node": "fake"},
            ),
            spec=NodeSpec(provider_id=KWOK_PROVIDER_PREFIX + name, taints=[UNREGISTERED_TAINT]),
            status=NodeStatus(
                # the claim's resource requests seed both vectors and the
                # instance type's numbers override shared keys
                # (kwok/cloudprovider.go:231-232): extended resources the
                # scheduler packed against — override-offering capacity, DRA
                # requests — survive on the launched node so pods can bind;
                # the chosen offering's capacity/overhead overrides
                # (types.go AllocatableOfferings) shape the real numbers
                capacity={
                    **node_claim.spec.resources,
                    **best_it.capacity,
                    **(best_offering.capacity_override or {}),
                },
                allocatable={
                    # assign, not sum (lo.Assign): instance-type numbers win
                    # on shared keys, request-only keys survive
                    **node_claim.spec.resources,
                    **best_it.compute_allocatable(
                        best_offering.capacity_override, best_offering.overhead_override
                    ),
                },
            ),
        )

    def _to_node_claim(self, node: Node) -> NodeClaim:
        it = self._by_name.get(node.metadata.labels.get(wk.INSTANCE_TYPE_LABEL_KEY, ""))
        nc = NodeClaim()
        nc.metadata = ObjectMeta(
            name=node.metadata.name,
            labels=dict(node.metadata.labels),
            annotations=dict(node.metadata.annotations),
        )
        nc.status.provider_id = node.spec.provider_id
        # the node was stamped with its offering's override-aware
        # capacity/allocatable at launch — prefer that record over the base
        # instance-type numbers
        if node.status.capacity or node.status.allocatable:
            nc.status.capacity = dict(node.status.capacity)
            nc.status.allocatable = dict(node.status.allocatable)
        else:
            nc.status.capacity = dict(it.capacity) if it else {}
            nc.status.allocatable = dict(it.allocatable()) if it else {}
        return nc
