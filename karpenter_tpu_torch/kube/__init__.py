"""In-memory Kubernetes substrate: typed objects + an apiserver-like store with
watches, optimistic concurrency, finalizers, and deletion semantics.

The reference's only distributed backend is the kube-apiserver (SURVEY.md L0);
tests there run against envtest (a real local apiserver). Here the same role is
played by `kube.Store` — an in-process object store with resourceVersion
semantics and watch fan-out — so every controller is a real reconciler and the
whole control plane is testable hermetically and deterministically.
"""

from .objects import (  # noqa: F401
    Affinity,
    Container,
    CSINode,
    CSINodeDriver,
    Deployment,
    Device,
    DeviceClass,
    Lease,
    NodeAffinity,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodAffinityTerm,
    PodSpec,
    PodStatus,
    PodTemplate,
    PreferredSchedulingTerm,
    ResourceClaim,
    ResourceClaimTemplate,
    ResourceSlice,
    StorageClass,
    VolumeAttachment,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from .store import Conflict, NotFound, Store  # noqa: F401
