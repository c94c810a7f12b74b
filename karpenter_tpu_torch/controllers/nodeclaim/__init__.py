"""NodeClaim controllers: lifecycle, garbage collection, consistency, expiration,
hydration, pod events and the disruption conditions."""
