from .controller import NodeOverlayController
from .store import InstanceTypeStore, InternalInstanceTypeStore, UnevaluatedNodePoolError

__all__ = [
    "NodeOverlayController",
    "InstanceTypeStore",
    "InternalInstanceTypeStore",
    "UnevaluatedNodePoolError",
]
