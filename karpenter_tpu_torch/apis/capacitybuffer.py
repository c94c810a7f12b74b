"""CapacityBuffer CRD: pre-provisioned headroom via placeholder pods.

Reference: pkg/apis/autoscaling/v1beta1/capacitybuffer.go — a buffer names a
pod shape (PodTemplate ref or a scalable workload ref) and a size (replicas,
percentage of the workload, and/or resource limits); the provisioner injects
that many virtual pods into every scheduling pass so spare capacity always
exists, and emptiness consolidation leaves the hosting nodes alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..kube.objects import ObjectMeta
from ..utils.quantity import Quantity
from .conditions import ConditionSet

COND_READY_FOR_PROVISIONING = "ReadyForProvisioning"

# constants.go:38-52
FAKE_POD_ANNOTATION_KEY = "karpenter.sh/capacity-buffer-fake-pod"
FAKE_POD_ANNOTATION_VALUE = "true"
BUFFER_NAME_LABEL = "karpenter.sh/capacity-buffer-name"
BUFFER_NAMESPACE_LABEL = "karpenter.sh/capacity-buffer-namespace"
# priority stamped onto virtual pods: below every real pod, so real demand
# always preempts headroom in FFD ordering (constants.go:48-52)
VIRTUAL_POD_PRIORITY = -(2**31)

ACTIVE_CAPACITY_STRATEGY = "buffer.x-k8s.io/active-capacity"


@dataclass
class ScalableRef:
    """A workload with replicas + a pod template (capacitybuffer.go:71-90)."""

    kind: str = ""
    name: str = ""
    api_group: str = "apps"


@dataclass
class CapacityBufferSpec:
    provisioning_strategy: str = ACTIVE_CAPACITY_STRATEGY
    pod_template_ref: Optional[str] = None  # PodTemplate name (same namespace)
    scalable_ref: Optional[ScalableRef] = None
    replicas: Optional[int] = None
    percentage: Optional[int] = None  # of scalable_ref's current replicas
    limits: dict[str, Quantity] = field(default_factory=dict)


@dataclass
class CapacityBufferStatus:
    pod_template_ref: Optional[str] = None
    replicas: Optional[int] = None
    pod_template_generation: Optional[int] = None
    provisioning_strategy: Optional[str] = None
    conditions: ConditionSet = field(default_factory=ConditionSet)


@dataclass
class CapacityBuffer:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CapacityBufferSpec = field(default_factory=CapacityBufferSpec)
    status: CapacityBufferStatus = field(default_factory=CapacityBufferStatus)
    kind: str = "CapacityBuffer"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def runtime_validate(self) -> list[str]:
        """The CRD CEL rules (capacitybuffer.go:92-94)."""
        errs = []
        if self.spec.pod_template_ref is not None and self.spec.scalable_ref is not None:
            errs.append("you must define either podTemplateRef or scalableRef, but not both")
        if self.spec.pod_template_ref is not None and self.spec.replicas is None and not self.spec.limits:
            errs.append("if podTemplateRef is set, replicas or limits must also be set")
        return errs


def is_virtual_pod(pod) -> bool:
    """True for the in-memory placeholder pods built from a buffer
    (buffers.go:220-225)."""
    return pod.metadata.annotations.get(FAKE_POD_ANNOTATION_KEY) == FAKE_POD_ANNOTATION_VALUE
