"""NodePool resource counter.

Reference: pkg/controllers/nodepool/counter/controller.go:74-97 — copies the
cluster-state per-pool resource totals into NodePool.status.resources and the
node count into status.node_count, gated on cluster sync so a fresh restart
can't patch a lower count over the truth.
"""

from __future__ import annotations

from ...utils.quantity import Quantity

BASE_RESOURCES = ("cpu", "memory", "pods", "ephemeral-storage", "nodes")


class NodePoolCounterController:
    def __init__(self, store, cluster):
        self.store = store
        self.cluster = cluster

    def reconcile(self) -> None:
        if not self.cluster.synced():
            return
        for np in self.store.list("NodePool"):
            resources = {name: Quantity(0) for name in BASE_RESOURCES}
            resources.update(self.cluster.nodepool_resources(np.metadata.name))
            count = self.cluster.nodepool_node_count(np.metadata.name)
            # the reference reports the count as the "nodes" resource too, which
            # is how per-pool node-count limits are expressed (counter.go:87-90)
            resources["nodes"] = Quantity.from_value(count)
            if np.status.resources != resources or np.status.node_count != count:
                def apply(obj, resources=resources, count=count):
                    obj.status.resources = resources
                    obj.status.node_count = count

                self.store.patch("NodePool", np.metadata.name, apply)
