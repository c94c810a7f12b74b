"""The NodePool drift-hash version (reference: pkg/controllers/nodepool/hash/
controller.go). The controller that stamps it is not ported yet; scheduling's
NodeClaim reads the version.
"""

from __future__ import annotations

# Bump when the fields included in NodePool.hash() change incompatibly
# (reference: nodepool.go:334 NodePoolHashVersion).
NODEPOOL_HASH_VERSION = "v1"

