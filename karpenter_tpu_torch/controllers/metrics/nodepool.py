"""NodePool observability controller.

Reference: pkg/controllers/metrics/nodepool/controller.go — per-pool
usage/limit gauges by resource type.
"""

from __future__ import annotations

from ... import metrics as m


class NodePoolMetricsController:
    def __init__(self, store, registry, cluster_cost=None):
        self.store = store
        self.registry = registry
        self.cluster_cost = cluster_cost

    def reconcile(self) -> None:
        usage = self.registry.gauge(m.NODEPOOL_USAGE)
        limit = self.registry.gauge(m.NODEPOOL_LIMIT)
        cost = self.registry.gauge(m.NODEPOOL_COST_TOTAL)
        usage.reset()
        limit.reset()
        cost.reset()
        for np in self.store.list("NodePool"):
            for res_name, q in np.status.resources.items():
                usage.set(q.as_float(), nodepool=np.metadata.name, resource_type=res_name)
            for res_name, q in np.spec.limits.items():
                limit.set(q.as_float(), nodepool=np.metadata.name, resource_type=res_name)
            if self.cluster_cost is not None:
                cost.set(self.cluster_cost.get_nodepool_cost(np.metadata.name), nodepool=np.metadata.name)
