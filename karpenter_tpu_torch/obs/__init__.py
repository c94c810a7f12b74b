"""Observability seams of the host code: the lock factories only."""
