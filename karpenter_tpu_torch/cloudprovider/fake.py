"""Fake cloud provider for unit tests: scripted errors, recorded calls,
assorted instance-type generator (reference: pkg/cloudprovider/fake/
cloudprovider.go:51-96 and instancetype.go:369 InstanceTypesAssorted).
"""

from __future__ import annotations

import itertools

from ..apis import labels as wk
from ..apis.nodeclaim import NodeClaim, NodeClaimStatus
from ..kube.objects import ObjectMeta
from ..scheduling.requirements import Requirements
from ..utils.quantity import Quantity
from . import catalog
from .errors import NodeClaimNotFoundError
from .types import InstanceType, RepairPolicy


class FakeCloudProvider:
    def __init__(self, instance_types: list[InstanceType] | None = None):
        self.instance_types = instance_types if instance_types is not None else default_instance_types()
        self.created: dict[str, NodeClaim] = {}  # provider_id -> claim
        self.create_calls: list[NodeClaim] = []
        self.delete_calls: list[NodeClaim] = []
        self.next_create_err: Exception | None = None
        self.next_delete_err: Exception | None = None
        self.next_get_err: Exception | None = None
        self.drifted: str = ""
        self._seq = itertools.count(1)
        # per-nodepool instance types: name -> list (falls back to global)
        self.instance_types_for_nodepool: dict[str, list[InstanceType]] = {}

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        self.create_calls.append(node_claim)
        if self.next_create_err is not None:
            err, self.next_create_err = self.next_create_err, None
            raise err
        reqs = Requirements.from_node_selector_terms(node_claim.spec.requirements)
        its = [it for it in self.instance_types if it.is_compatible(reqs)]
        if not its:
            from .errors import InsufficientCapacityError

            raise InsufficientCapacityError("no compatible instance type")
        chosen = min(
            its,
            key=lambda it: min((o.price for o in it.offerings if o.available and reqs.intersects(o.requirements) is None), default=float("inf")),
        )
        offering = min(
            (o for o in chosen.offerings if o.available and reqs.intersects(o.requirements) is None),
            key=lambda o: o.price,
        )
        pid = f"fake://{node_claim.metadata.name}-{next(self._seq)}"
        out = NodeClaim(
            metadata=ObjectMeta(
                name=node_claim.metadata.name,
                labels={
                    **node_claim.metadata.labels,
                    wk.INSTANCE_TYPE_LABEL_KEY: chosen.name,
                    wk.ZONE_LABEL_KEY: offering.zone(),
                    wk.CAPACITY_TYPE_LABEL_KEY: offering.capacity_type(),
                },
            ),
            spec=node_claim.spec,
            status=NodeClaimStatus(
                provider_id=pid,
                capacity=dict(chosen.capacity),
                allocatable=dict(chosen.allocatable()),
            ),
        )
        self.created[pid] = out
        return out

    def delete(self, node_claim: NodeClaim) -> None:
        self.delete_calls.append(node_claim)
        if self.next_delete_err is not None:
            err, self.next_delete_err = self.next_delete_err, None
            raise err
        if node_claim.status.provider_id not in self.created:
            raise NodeClaimNotFoundError(node_claim.status.provider_id)
        del self.created[node_claim.status.provider_id]

    def get(self, provider_id: str) -> NodeClaim:
        if self.next_get_err is not None:
            err, self.next_get_err = self.next_get_err, None
            raise err
        if provider_id not in self.created:
            raise NodeClaimNotFoundError(provider_id)
        return self.created[provider_id]

    def list(self) -> list[NodeClaim]:
        return list(self.created.values())

    def get_instance_types(self, node_pool=None) -> list[InstanceType]:
        if node_pool is not None and node_pool.metadata.name in self.instance_types_for_nodepool:
            return self.instance_types_for_nodepool[node_pool.metadata.name]
        return self.instance_types

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return self.drifted

    def repair_policies(self) -> list[RepairPolicy]:
        return [RepairPolicy("Ready", "False", 10 * 60)]

    def name(self) -> str:
        return "fake"

    def get_supported_node_classes(self) -> list[str]:
        return ["KWOKNodeClass"]


def default_instance_types() -> list[InstanceType]:
    """A small assorted set (like fake.InstanceTypes(5)): linux/amd64, two zones."""
    out = []
    for family, cpu in (("c", 1), ("c", 4), ("s", 8), ("m", 16), ("c", 32)):
        out.append(
            catalog.make_instance_type(family, cpu, zones=["test-zone-a", "test-zone-b", "test-zone-c"])
        )
    return out


def instance_types_assorted(count: int = 400) -> list[InstanceType]:
    """A large combinatorial set for benchmarks (fake/instancetype.go:369)."""
    out = []
    combos = itertools.cycle(
        [
            (f, c, a, o)
            for f in catalog.FAMILIES
            for c in catalog.SIZES
            for a in catalog.ARCHS
            for o in catalog.OSES
        ]
    )
    seen = set()
    zone_opts = [["test-zone-a"], ["test-zone-b"], ["test-zone-a", "test-zone-b"], catalog.ZONES]
    while len(out) < count:
        f, c, a, o = next(combos)
        # mix a div-4 term in so zone variety survives the period-4 arch/os
        # cycle (a pure linear index collapses on multiples of 4)
        i = len(out)
        zones = zone_opts[(i + i // 4) % len(zone_opts)]
        key = (f, c, a, o, tuple(zones))
        it = catalog.make_instance_type(f, c, a, o, zones=zones)
        if key in seen:
            # distinct combos exhausted: emit a renamed variant
            from ..scheduling.requirements import Requirement

            it.name = f"{it.name}-v{len(out)}"
            it.requirements.replace(Requirement(wk.INSTANCE_TYPE_LABEL_KEY, "In", [it.name]))
        else:
            seen.add(key)
        out.append(it)
    return out[:count]
