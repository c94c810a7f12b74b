"""Dynamic Resource Allocation (reference: pkg/scheduling/dynamicresources).

Simulates DRA device assignment during scheduling so pods requesting devices
(GPUs, NICs, ...) via ResourceClaims drive node provisioning the same way
resource requests do.
"""

from .allocator import (  # noqa: F401
    ALLOCATE_TIMEOUT_SECONDS,
    AllocationResult,
    Allocator,
    device_matches_selectors,
    resolve_pod_claims,
)
