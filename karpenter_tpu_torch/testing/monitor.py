"""Monitor: cluster observation helpers for e2e/perf suites.

Reference: test/pkg/environment/common/monitor.go:53-219 — tracks node/pod
deltas from a reset point and computes node utilization, so suites can assert
"scaled out by N nodes", "all pods of deployment X running", and "average
CPU utilization above Y" without poking at raw store state.
"""

from __future__ import annotations

from ..apis import labels as wk
from ..utils import pods as pod_utils
from ..utils import resources as res


class Monitor:
    def __init__(self, store, cluster):
        self.store = store
        self.cluster = cluster
        self.reset()

    def reset(self) -> None:
        """Record the baseline for created/deleted deltas (monitor.go Reset)."""
        self._base_nodes = {n.metadata.name for n in self.store.borrow_list("Node")}
        self._base_node_count = len(self._base_nodes)

    # -- nodes -----------------------------------------------------------------
    def node_count(self) -> int:
        return self.store.count("Node")

    def created_nodes(self) -> list:
        return [n for n in self.store.list("Node") if n.metadata.name not in self._base_nodes]

    def created_node_count(self) -> int:
        return len(self.created_nodes())

    def deleted_node_count(self) -> int:
        current = {n.metadata.name for n in self.store.borrow_list("Node")}
        return len(self._base_nodes - current)

    # -- pods ------------------------------------------------------------------
    def running_pod_count(self, selector: dict | None = None) -> int:
        from ..kube.objects import match_label_selector

        n = 0
        for p in self.store.borrow_list("Pod"):
            if not p.spec.node_name or not pod_utils.is_active(p):
                continue
            if selector is not None and not match_label_selector(selector, p.metadata.labels):
                continue
            n += 1
        return n

    def pending_pod_count(self) -> int:
        return sum(1 for p in self.store.borrow_list("Pod") if pod_utils.is_provisionable(p))

    # -- utilization (monitor.go:176-219) --------------------------------------
    def avg_utilization(self, resource: str = "cpu") -> float:
        """Mean over nodes of (requested / allocatable) for the resource."""
        utils = self.node_utilizations(resource)
        return sum(utils) / len(utils) if utils else 0.0

    def min_utilization(self, resource: str = "cpu") -> float:
        utils = self.node_utilizations(resource)
        return min(utils) if utils else 0.0

    def node_utilizations(self, resource: str = "cpu") -> list[float]:
        requested: dict[str, float] = {}
        for p in self.store.borrow_list("Pod"):
            if p.spec.node_name and pod_utils.is_active(p):
                q = res.pod_requests(p).get(resource)
                if q is not None:
                    requested[p.spec.node_name] = requested.get(p.spec.node_name, 0.0) + q.milli
        out = []
        for n in self.store.borrow_list("Node"):
            alloc = n.status.allocatable.get(resource)
            if alloc is None or alloc.milli == 0:
                continue
            out.append(requested.get(n.metadata.name, 0.0) / alloc.milli)
        return out

    def node_pool_node_count(self, pool: str) -> int:
        return sum(1 for n in self.store.borrow_list("Node") if n.metadata.labels.get(wk.NODEPOOL_LABEL_KEY) == pool)
