"""CloudProvider SPI and the InstanceType/Offering data model the solver consumes."""

from .types import (  # noqa: F401
    CloudProvider,
    InstanceType,
    InstanceTypeOverhead,
    Offering,
    RepairPolicy,
    cheapest,
    compatible_instance_types,
    order_by_price,
    worst_launch_price,
)
from .errors import (  # noqa: F401
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    NodeClassNotReadyError,
)
