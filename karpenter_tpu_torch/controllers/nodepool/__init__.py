"""NodePool controllers: only the drift-hash version the scheduler stamps."""
