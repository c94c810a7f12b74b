"""Pod observability controller.

Reference: pkg/controllers/metrics/pod/controller.go — tracks pod scheduling
latency: creation->bound, creation->running, and the live unbound gauge. The
bound/startup histograms are the headline scheduling-latency metrics.
"""

from __future__ import annotations

from ... import metrics as m
from ...apis import labels as wk


class PodMetricsController:
    def __init__(self, store, clock, registry):
        self.store = store
        self.clock = clock
        self.registry = registry
        self._bound_seen: set[str] = set()
        self._started_seen: set[str] = set()

    def reconcile(self) -> None:
        unbound = self.registry.gauge(m.PODS_UNBOUND_TIME)
        state = self.registry.gauge(m.PODS_STATE)
        unbound.reset()
        state.reset()
        live = set()
        for pod in self.store.list("Pod"):
            key = pod.key()
            live.add(key)
            created = pod.metadata.creation_timestamp
            state.set(1, name=pod.metadata.name, namespace=pod.metadata.namespace, phase=pod.status.phase)  # solverlint: ok(metric-label-cardinality): phase is the k8s PodPhase enum (Pending/Running/Succeeded/Failed/Unknown) — bounded by the API contract, not by this module
            if not pod.spec.node_name:
                unbound.set(self.clock.now() - created, name=pod.metadata.name, namespace=pod.metadata.namespace)
                continue
            if key not in self._bound_seen:
                self._bound_seen.add(key)
                self.registry.histogram(m.PODS_BOUND_DURATION).observe(self.clock.now() - created)
                node = self.store.try_get("Node", pod.spec.node_name)
                if node is not None and wk.NODEPOOL_LABEL_KEY in node.metadata.labels:
                    self.registry.histogram(m.PODS_PROVISIONING_BOUND_DURATION).observe(self.clock.now() - created)
            if pod.status.phase == "Running" and key not in self._started_seen:
                self._started_seen.add(key)
                self.registry.histogram(m.PODS_STARTUP_DURATION).observe(self.clock.now() - created)
        self._bound_seen &= live
        self._started_seen &= live
