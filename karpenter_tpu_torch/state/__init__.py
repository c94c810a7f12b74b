"""In-memory cluster state: the Cluster/StateNode mirror all decisions read from."""

from .cluster import Cluster  # noqa: F401
from .statenode import StateNode  # noqa: F401
