"""API types: NodePool, NodeClaim, NodeOverlay, CapacityBuffer + well-known labels."""
