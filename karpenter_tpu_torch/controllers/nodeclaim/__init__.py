"""NodeClaim controllers: only the disruption conditions the disruption methods read."""
