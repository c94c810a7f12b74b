"""Static capacity: replica-count NodePools maintained as fixed fleets.

Reference: pkg/controllers/static/{provisioning,deprovisioning} — a NodePool
with spec.replicas set is excluded from demand-driven provisioning; these two
controllers scale the fleet up (create NodeClaims straight from the template)
and down (drain-priority-ordered NodeClaim deletion).
"""

from .provisioning import StaticProvisioningController  # noqa: F401
from .deprovisioning import StaticDeprovisioningController  # noqa: F401
