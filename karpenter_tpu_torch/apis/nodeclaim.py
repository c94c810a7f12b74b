"""NodeClaim API type (reference: pkg/apis/v1/nodeclaim.go + nodeclaim_status.go).

A NodeClaim is the request for capacity: created by the provisioner, launched
by the cloud provider, matched to a Node on registration, and finalized by the
termination controller.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..kube.objects import ObjectMeta
from ..scheduling.taints import Taint
from ..utils.quantity import Quantity
from .conditions import ConditionSet

# Condition types (nodeclaim_status.go)
COND_LAUNCHED = "Launched"
COND_REGISTERED = "Registered"
COND_INITIALIZED = "Initialized"
COND_READY = "Ready"
COND_DRIFTED = "Drifted"
COND_CONSOLIDATABLE = "Consolidatable"
COND_DISRUPTION_REASON = "DisruptionReason"
COND_INSTANCE_TERMINATING = "InstanceTerminating"
COND_CONSISTENT_STATE_FOUND = "ConsistentStateFound"

LIVENESS_CONDITIONS = (COND_LAUNCHED, COND_REGISTERED)


@dataclass
class NodeClassReference:
    group: str = "karpenter.kwok.sh"
    kind: str = "KWOKNodeClass"
    name: str = "default"


@dataclass
class NodeClaimSpec:
    taints: list[Taint] = field(default_factory=list)
    startup_taints: list[Taint] = field(default_factory=list)
    requirements: list[dict] = field(default_factory=list)  # {key, operator, values, minValues?}
    resources: dict[str, Quantity] = field(default_factory=dict)  # minimum resource requests
    node_class_ref: NodeClassReference = field(default_factory=NodeClassReference)
    termination_grace_period: Optional[float] = None  # seconds
    expire_after: Optional[float] = None  # seconds; None/inf = never


@dataclass
class NodeClaimStatus:
    provider_id: str = ""
    node_name: str = ""
    image_id: str = ""
    capacity: dict[str, Quantity] = field(default_factory=dict)
    allocatable: dict[str, Quantity] = field(default_factory=dict)
    conditions: ConditionSet = field(default_factory=ConditionSet)
    last_pod_event_time: float = 0.0


@dataclass
class NodeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)
    kind: str = "NodeClaim"

    def key(self) -> str:
        return self.metadata.name

    @property
    def nodepool_name(self) -> str | None:
        from . import labels as wk

        return self.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)

    def is_launched(self) -> bool:
        return self.status.conditions.is_true(COND_LAUNCHED)

    def is_registered(self) -> bool:
        return self.status.conditions.is_true(COND_REGISTERED)

    def is_initialized(self) -> bool:
        return self.status.conditions.is_true(COND_INITIALIZED)
