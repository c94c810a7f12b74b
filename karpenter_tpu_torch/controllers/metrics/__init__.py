from .node import NodeMetricsController
from .nodepool import NodePoolMetricsController
from .pod import PodMetricsController

__all__ = ["NodeMetricsController", "NodePoolMetricsController", "PodMetricsController"]
