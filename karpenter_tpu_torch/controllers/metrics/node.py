"""Node observability controller.

Reference: pkg/controllers/metrics/node/controller.go — per-node gauges:
allocatable, total pod/daemon requests, utilization percent, lifetime.
"""

from __future__ import annotations

from ... import metrics as m
from ...apis import labels as wk


class NodeMetricsController:
    def __init__(self, store, cluster, clock, registry):
        self.store = store
        self.cluster = cluster
        self.clock = clock
        self.registry = registry

    def reconcile(self) -> None:
        allocatable = self.registry.gauge(m.NODES_ALLOCATABLE)
        pod_req = self.registry.gauge(m.NODES_TOTAL_POD_REQUESTS)
        daemon_req = self.registry.gauge(m.NODES_TOTAL_DAEMON_REQUESTS)
        util = self.registry.gauge(m.NODES_UTILIZATION)
        lifetime = self.registry.gauge(m.NODES_CURRENT_LIFETIME)
        for g in (allocatable, pod_req, daemon_req, util, lifetime):
            g.reset()
        for sn in self.cluster.nodes():
            labels = sn.labels()
            pool = labels.get(wk.NODEPOOL_LABEL_KEY, "")
            zone = labels.get(wk.ZONE_LABEL_KEY, "")
            name = sn.name()
            alloc = sn.allocatable()
            requested = sn.total_pod_requests()
            daemon = sn.total_daemon_requests()
            for res_name, q in alloc.items():
                allocatable.set(q.as_float(), node_name=name, nodepool=pool, resource_type=res_name, zone=zone)
                req = requested.get(res_name)
                if req is not None:
                    pod_req.set(req.as_float(), node_name=name, nodepool=pool, resource_type=res_name)
                    if q.as_float() > 0:
                        util.set(100.0 * req.as_float() / q.as_float(), node_name=name, nodepool=pool, resource_type=res_name)
            for res_name, q in daemon.items():
                daemon_req.set(q.as_float(), node_name=name, nodepool=pool, resource_type=res_name)
            created = (
                sn.node.metadata.creation_timestamp
                if sn.node is not None
                else sn.node_claim.metadata.creation_timestamp if sn.node_claim is not None else 0.0
            )
            lifetime.set(self.clock.now() - created, node_name=name, nodepool=pool)
