"""Solver entry points of the port (encoded problem -> validated placement)."""
