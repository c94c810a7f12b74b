"""Solver entry points of the port (encoded problem -> validated placement)."""

from .ffd import FFDSolver  # noqa: F401
from .snapshot import SolverSnapshot  # noqa: F401
