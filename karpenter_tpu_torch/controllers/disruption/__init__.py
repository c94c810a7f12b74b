"""Disruption: consolidation (single/multi-node), emptiness, drift —
the reference's second computational heart (SURVEY.md §3.2).
"""

from .controller import DisruptionController  # noqa: F401
from .types import Candidate, Command  # noqa: F401
