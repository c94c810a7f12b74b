"""Static capacity: replica-count NodePools maintained as fixed fleets."""
