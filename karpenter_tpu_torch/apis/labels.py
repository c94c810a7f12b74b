"""Well-known label keys and normalization tables.

Mirrors the label surface of the reference's pkg/apis/v1/labels.go:
the karpenter.sh domain labels, the restricted-label validation sets, and
the NormalizedLabels aliasing (beta.kubernetes.io/* -> kubernetes.io/*).
"""

from __future__ import annotations

GROUP = "karpenter.sh"

# -- karpenter.sh domain ------------------------------------------------------
NODEPOOL_LABEL_KEY = f"{GROUP}/nodepool"
CAPACITY_TYPE_LABEL_KEY = f"{GROUP}/capacity-type"
NODE_REGISTERED_LABEL_KEY = f"{GROUP}/registered"
NODE_INITIALIZED_LABEL_KEY = f"{GROUP}/initialized"
# reference: pkg/cloudprovider/types.go ReservationIDLabel
RESERVATION_ID_LABEL_KEY = f"{GROUP}/reservation-id"

CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"

# -- kubernetes.io domain -----------------------------------------------------
ARCH_LABEL_KEY = "kubernetes.io/arch"
OS_LABEL_KEY = "kubernetes.io/os"
HOSTNAME_LABEL_KEY = "kubernetes.io/hostname"
INSTANCE_TYPE_LABEL_KEY = "node.kubernetes.io/instance-type"
ZONE_LABEL_KEY = "topology.kubernetes.io/zone"
REGION_LABEL_KEY = "topology.kubernetes.io/region"
WINDOWS_BUILD_LABEL_KEY = "node.kubernetes.io/windows-build"

ARCH_AMD64 = "amd64"
ARCH_ARM64 = "arm64"
OS_LINUX = "linux"
OS_WINDOWS = "windows"

# Annotations
NODEPOOL_HASH_ANNOTATION_KEY = f"{GROUP}/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION_KEY = f"{GROUP}/nodepool-hash-version"
DO_NOT_DISRUPT_ANNOTATION_KEY = f"{GROUP}/do-not-disrupt"
NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY = f"{GROUP}/nodeclaim-termination-timestamp"
NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY = f"{GROUP}/nodeclaim-min-values-relaxed"

# Taints
DISRUPTED_TAINT_KEY = f"{GROUP}/disrupted"
UNREGISTERED_TAINT_KEY = f"{GROUP}/unregistered"
# node label a provider sets when IT manages taints: registration skips
# syncing claim taints/startupTaints (labels.go:44, registration.go:211-217)
NODE_DO_NOT_SYNC_TAINTS_LABEL_KEY = f"{GROUP}/do-not-sync-taints"

# Finalizers
TERMINATION_FINALIZER = f"{GROUP}/termination"

# Labels a NodePool may not set directly (reference labels.go:113-117
# RestrictedLabels — ONLY the hostname label; plain kubernetes.io/k8s.io
# domain labels are allowed, see suite_test.go:1578 "should label nodes with
# labels in the kubernetes domains")
RESTRICTED_LABELS = {
    HOSTNAME_LABEL_KEY,
}

# Domains reserved by karpenter itself (labels.go:68-71 RestrictedLabelDomains)
RESTRICTED_LABEL_DOMAINS = {
    GROUP,
}

# Labels the scheduler may leave undefined on an InstanceType and still be
# compatible with pods requiring them (reference: labels.go:75-84 WellKnownLabels;
# used by Requirements.Compatible(allow_undefined=WELL_KNOWN_LABELS)).
# NOTE: hostname is deliberately NOT well-known — it is restricted (labels.go:115-117).
WELL_KNOWN_LABELS = {
    NODEPOOL_LABEL_KEY,
    CAPACITY_TYPE_LABEL_KEY,
    # providers register their reservation-id label as well-known so claims
    # without a reservation requirement stay compatible with reserved
    # offerings (reference fake/cloudprovider.go:43-47 init)
    RESERVATION_ID_LABEL_KEY,
    ZONE_LABEL_KEY,
    REGION_LABEL_KEY,
    INSTANCE_TYPE_LABEL_KEY,
    ARCH_LABEL_KEY,
    OS_LABEL_KEY,
    WINDOWS_BUILD_LABEL_KEY,
}

# Deprecated -> canonical label aliasing (reference: labels.go NormalizedLabels).
NORMALIZED_LABELS = {
    "beta.kubernetes.io/arch": ARCH_LABEL_KEY,
    "beta.kubernetes.io/os": OS_LABEL_KEY,
    "beta.kubernetes.io/instance-type": INSTANCE_TYPE_LABEL_KEY,
    "failure-domain.beta.kubernetes.io/zone": ZONE_LABEL_KEY,
    "failure-domain.beta.kubernetes.io/region": REGION_LABEL_KEY,
    "topology.gke.io/zone": ZONE_LABEL_KEY,
}

# Per-key value normalization (reference: labels.go NormalizedLabelValues).
NORMALIZED_LABEL_VALUES: dict[str, dict[str, str]] = {
    ARCH_LABEL_KEY: {"x86_64": ARCH_AMD64, "aarch64": ARCH_ARM64},
}


def normalize_key(key: str) -> str:
    return NORMALIZED_LABELS.get(key, key)


def normalize_value(key: str, value: str) -> str:
    table = NORMALIZED_LABEL_VALUES.get(key)
    if table:
        return table.get(value, value)
    return value


def is_restricted(key: str) -> bool:
    """True if a NodePool template may not set this label (labels.go IsRestrictedLabel)."""
    if key in WELL_KNOWN_LABELS:
        return False
    if key in RESTRICTED_LABELS:
        return True
    domain = key.split("/", 1)[0] if "/" in key else ""
    return any(domain == d or domain.endswith("." + d) for d in RESTRICTED_LABEL_DOMAINS)
