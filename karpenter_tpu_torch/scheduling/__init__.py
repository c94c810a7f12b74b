"""Scheduling primitives: Requirements algebra, taints, host ports, volume usage."""

from .requirements import Requirement, Requirements, Operator  # noqa: F401
from .taints import Taint, Toleration, taints_tolerate_pod  # noqa: F401
