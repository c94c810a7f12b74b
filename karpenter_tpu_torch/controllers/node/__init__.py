"""Node controllers: termination and health."""
