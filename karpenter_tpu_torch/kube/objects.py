"""Typed, lightweight equivalents of the corev1 objects the framework consumes.

These are plain dataclasses — not a port of client-go — carrying exactly the
fields the reference's controllers read (pod scheduling constraints, node
capacity/taints, metadata with finalizers/owner-refs). Everything else is
intentionally absent.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from ..scheduling.taints import Taint
from ..utils.quantity import Quantity


def new_uid() -> str:
    return f"{uuid.uuid4()}"


@dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str
    api_version: str = "v1"
    controller: bool = False
    block_owner_deletion: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)
    owner_references: list[OwnerReference] = field(default_factory=list)
    resource_version: int = 0
    generation: int = 1
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None


@dataclass
class Container:
    name: str = "main"
    # resources: {"requests": {res: Quantity}, "limits": {res: Quantity}}
    resources: dict[str, dict[str, Quantity]] = field(default_factory=dict)
    ports: list[dict] = field(default_factory=list)  # {containerPort, hostPort?, hostIP?, protocol?}
    # For init containers: restart_policy == "Always" marks a sidecar (KEP-753).
    restart_policy: str | None = None

    def is_sidecar(self) -> bool:
        return self.restart_policy == "Always"


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: list[dict] = field(default_factory=list)  # [{key, operator, values}]


@dataclass
class NodeAffinity:
    # required: list of OR'd terms; each term is a list of AND'd {key, operator, values}
    required: list[list[dict]] = field(default_factory=list)
    preferred: list[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    label_selector: dict | None = None  # {"matchLabels": {...}, "matchExpressions": [...]}
    topology_key: str = ""
    namespaces: list[str] = field(default_factory=list)
    namespace_selector: dict | None = None


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class Affinity:
    node_affinity: NodeAffinity | None = None
    pod_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    pod_affinity_preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: dict | None = None
    min_domains: int | None = None
    node_affinity_policy: str = "Honor"  # Honor | Ignore
    node_taints_policy: str = "Ignore"  # Honor | Ignore
    # pod label keys whose VALUES merge into the selector (k8s >= 1.27
    # matchLabelKeys; topology.go:467-475) — e.g. pod-template-hash for
    # per-revision spread
    match_label_keys: list[str] = field(default_factory=list)


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=lambda: [Container()])
    init_containers: list[Container] = field(default_factory=list)
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Affinity | None = None
    tolerations: list[Any] = field(default_factory=list)
    topology_spread_constraints: list[TopologySpreadConstraint] = field(default_factory=list)
    node_name: str = ""
    priority: int | None = None
    priority_class_name: str = ""
    preemption_policy: str = "PreemptLowerPriority"
    scheduler_name: str = "default-scheduler"
    overhead: dict[str, Quantity] = field(default_factory=dict)
    volumes: list[dict] = field(default_factory=list)
    termination_grace_period_seconds: int | None = 30
    restart_policy: str = "Always"
    host_network: bool = False
    resource_claims: list[dict] = field(default_factory=list)  # DRA: [{name, resourceClaimName | resourceClaimTemplateName}]


@dataclass
class PodCondition:
    type: str
    status: str = "True"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class PodStatus:
    phase: str = "Pending"
    conditions: list[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""
    start_time: Optional[float] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class NodeSpec:
    provider_id: str = ""
    taints: list[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class NodeCondition:
    type: str
    status: str = "True"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class NodeStatus:
    capacity: dict[str, Quantity] = field(default_factory=dict)
    allocatable: dict[str, Quantity] = field(default_factory=dict)
    conditions: list[NodeCondition] = field(default_factory=list)
    node_info: dict[str, str] = field(default_factory=dict)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)
    kind: str = "Node"

    def key(self) -> str:
        return self.metadata.name


@dataclass
class DaemonSet:
    """Minimal DaemonSet: the scheduler precomputes per-node daemon overhead
    from its pod template."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template_spec: PodSpec = field(default_factory=PodSpec)
    template_metadata: ObjectMeta = field(default_factory=ObjectMeta)
    kind: str = "DaemonSet"

    def to_pod(self) -> "Pod":
        import copy as _copy

        pod = Pod(spec=_copy.deepcopy(self.template_spec))
        pod.metadata.namespace = self.metadata.namespace
        pod.metadata.name = f"{self.metadata.name}-daemon"
        pod.metadata.labels = dict(self.template_metadata.labels)
        pod.metadata.owner_references = [
            OwnerReference(kind="DaemonSet", name=self.metadata.name, uid=self.metadata.uid, controller=True)
        ]
        return pod


@dataclass
class PodTemplate:
    """The pod-shape object a CapacityBuffer's podTemplateRef points at."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template_spec: PodSpec = field(default_factory=PodSpec)
    template_metadata: ObjectMeta = field(default_factory=ObjectMeta)
    kind: str = "PodTemplate"


@dataclass
class Deployment:
    """Minimal scalable workload: replicas + a pod template. Stands in for
    Deployment/ReplicaSet/StatefulSet as a CapacityBuffer scalableRef target."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    template_spec: PodSpec = field(default_factory=PodSpec)
    template_metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: dict | None = None
    kind: str = "Deployment"


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # spec
    volume_name: str = ""  # bound PV name ("" = unbound)
    storage_class_name: str | None = None  # None = default class; "" = disabled
    # status
    phase: str = "Pending"  # Pending | Bound | Lost
    kind: str = "PersistentVolumeClaim"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    csi_driver: str = ""  # spec.csi.driver ("" = non-CSI)
    # legacy in-tree volume source plugin name (e.g. "kubernetes.io/aws-ebs"
    # for spec.awsElasticBlockStore); CSI-migrated for limit tracking
    # (volumeusage.go:169-181 driverFromVolume)
    in_tree_source: str = ""
    # spec.nodeAffinity.required.nodeSelectorTerms: OR'd terms, each a list of
    # AND'd {key, operator, values} dicts
    node_affinity_required: list[list[dict]] = field(default_factory=list)
    local: bool = False  # spec.local set
    host_path: bool = False  # spec.hostPath set
    kind: str = "PersistentVolume"


@dataclass
class VolumeAttachment:
    """storagev1.VolumeAttachment: a volume attached to a node. Termination
    waits for these to detach before deleting the instance
    (node/termination/controller.go awaitVolumeDetachment)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    attacher: str = ""  # spec.attacher (CSI driver)
    node_name: str = ""  # spec.nodeName
    persistent_volume_name: str = ""  # spec.source.persistentVolumeName
    attached: bool = True  # status.attached
    kind: str = "VolumeAttachment"


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = "Immediate"  # Immediate | WaitForFirstConsumer
    # AllowedTopologies: OR'd TopologySelectorTerms, each a list of AND'd
    # {key, values} matchLabelExpressions
    allowed_topologies: list[list[dict]] = field(default_factory=list)
    kind: str = "StorageClass"


@dataclass
class CSINodeDriver:
    name: str = ""
    allocatable_count: int | None = None  # max volumes this driver can attach


@dataclass
class CSINode:
    """Named after the node it describes; carries per-driver volume limits."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: list[CSINodeDriver] = field(default_factory=list)
    kind: str = "CSINode"


@dataclass
class Device:
    """One allocatable device in a ResourceSlice (resourcev1.Device)."""

    name: str = ""
    # qualified attribute name ("driver/attr" or plain) -> str | int | bool
    attributes: dict[str, Any] = field(default_factory=dict)
    capacity: dict[str, Quantity] = field(default_factory=dict)
    # DRA driver name; on slice-published devices the ResourceSlice's driver
    # wins, but instance-type template devices (cloudprovider
    # dynamicresources.go:41-44 ResourceSliceTemplate.Driver) declare theirs
    # here so CEL `device.driver` selectors see it pre-launch
    driver: str = ""
    # multi-allocatable (consumable-capacity) devices can serve several claims
    # until their capacity is exhausted
    allow_multiple_allocations: bool = False
    # partitionable devices (resourcev1 Device.ConsumesCounters): allocating
    # this device draws from its pool's shared counter sets — e.g. MIG
    # partitions consuming slices of one physical GPU's memory/SM budget
    # [{"counterSet": str, "counters": {name: Quantity|str}}]
    consumes_counters: list[dict] = field(default_factory=list)
    # node requirements selecting this device pins (template devices only):
    # the topology the launched node must satisfy when the device is chosen —
    # feeds per-instance-type requirement superposition
    # (allocator.go:90-134 ContributedRequirements)
    # [{"key", "operator", "values"}]
    requirements: list[dict] = field(default_factory=list)


@dataclass
class ResourceSlice:
    """A driver's published pool chunk of devices on a node (resourcev1)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    driver: str = ""
    pool_name: str = ""
    pool_generation: int = 1
    node_name: str = ""  # "" + all_nodes=False means selector-scoped
    all_nodes: bool = False
    node_selector: list[list[dict]] = field(default_factory=list)  # OR'd terms
    devices: list[Device] = field(default_factory=list)
    # pool-level shared counter budgets (resourcev1 CounterSet): devices in
    # this pool draw from these via consumes_counters
    # [{"name": str, "counters": {counter name: Quantity|str}}]
    shared_counters: list[dict] = field(default_factory=list)
    kind: str = "ResourceSlice"


@dataclass
class DeviceClass:
    """Selector bundle a claim request references by class name."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selectors: list[dict] = field(default_factory=list)
    kind: str = "DeviceClass"


@dataclass
class ResourceClaimStatus:
    # {"devices": [{request, driver, pool, device, consumedCapacity?}],
    #  "nodeName": str} once allocated
    allocation: Optional[dict] = None
    reserved_for: list[str] = field(default_factory=list)  # pod uids


@dataclass
class ResourceClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # requests: [{name, deviceClassName?, selectors?, count?, allocationMode?,
    #             capacity?}]
    requests: list[dict] = field(default_factory=list)
    # constraints: [{"matchAttribute": "driver/attr", "requests": [names]?}]
    constraints: list[dict] = field(default_factory=list)
    status: ResourceClaimStatus = field(default_factory=ResourceClaimStatus)
    kind: str = "ResourceClaim"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class ResourceClaimTemplate:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    requests: list[dict] = field(default_factory=list)
    constraints: list[dict] = field(default_factory=list)
    kind: str = "ResourceClaimTemplate"


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: dict | None = None  # metav1 label selector
    min_available: int | str | None = None
    max_unavailable: int | str | None = None
    kind: str = "PodDisruptionBudget"


@dataclass
class Lease:
    """coordinationv1.Lease — the leader-election lock object."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0
    kind: str = "Lease"


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    kind: str = "PriorityClass"


def match_label_selector(selector: dict | None, labels: dict[str, str]) -> bool:
    """metav1.LabelSelector matching: matchLabels AND matchExpressions."""
    if selector is None:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key, op, values = expr["key"], expr["operator"], expr.get("values", [])
        val = labels.get(key)
        if op == "In":
            if val not in values:
                return False
        elif op == "NotIn":
            if val in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
    return True
