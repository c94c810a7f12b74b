"""Incremental per-NodePool cost totals.

Reference: pkg/state/cost/cost.go:68-114 — ClusterCost tracks the running
price of every NodeClaim by (instance-type, zone, capacity-type) offering so
the Balanced consolidation policy can normalise savings against pool cost
without re-summing offerings on every decision (balanced.go:39-101).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..apis import labels as wk

# NodeClaims must carry these labels before they can be costed
# (cost.go:40-42 NecessaryLabels); absence is retried, not an error.
NECESSARY_LABELS = (
    wk.INSTANCE_TYPE_LABEL_KEY,
    wk.CAPACITY_TYPE_LABEL_KEY,
    wk.ZONE_LABEL_KEY,
    wk.NODEPOOL_LABEL_KEY,
)


def _build_price_index(instance_types) -> dict[tuple[str, str, str], float]:
    """(zone, capacity_type, instance_name) -> price for a pool's catalog."""
    index: dict[tuple[str, str, str], float] = {}
    for it in instance_types:
        for o in it.offerings:
            index[(o.zone(), o.capacity_type(), it.name)] = o.price
    return index


@dataclass
class _OfferingCount:
    count: int = 0
    price: float = 0.0  # unit price, not price * count


@dataclass
class _NodePoolCost:
    cost: float = 0.0
    # (zone, capacity_type, instance_name) -> _OfferingCount
    offerings: dict[tuple[str, str, str], _OfferingCount] = field(default_factory=dict)


class ClusterCost:
    """Running cost totals, updated incrementally from NodeClaim churn.

    cost.go:122-157 (price refresh), 161-228 (claim add/remove),
    307-323 (totals).
    """

    def __init__(self, store, cloud_provider, metrics=None):
        self.store = store
        self.cloud_provider = cloud_provider
        self.metrics = metrics
        self._pools: dict[str, _NodePoolCost] = {}
        self._claims: dict[str, tuple[str, tuple[str, str, str]]] = {}  # claim name -> (pool, key)
        self._price_index: dict[str, dict[tuple[str, str, str], float]] = {}  # pool -> offering key -> price

    def _record_error(self, pool: str) -> None:
        if self.metrics is not None:
            from .. import metrics as m

            self.metrics.counter(m.NODEPOOL_COST_TRACKER_ERRORS_TOTAL).inc(nodepool=pool)

    # -- claim tracking (cost.go:161-228) --------------------------------------
    def update_node_claim(self, node_claim) -> None:
        name = node_claim.metadata.name
        if name in self._claims:
            return
        labels = node_claim.metadata.labels
        if any(k not in labels for k in NECESSARY_LABELS):
            return  # labels propagate later; retried on the next MODIFIED event
        pool = labels[wk.NODEPOOL_LABEL_KEY]
        key = (labels[wk.ZONE_LABEL_KEY], labels[wk.CAPACITY_TYPE_LABEL_KEY], labels[wk.INSTANCE_TYPE_LABEL_KEY])
        npc = self._pools.setdefault(pool, _NodePoolCost())
        oc = npc.offerings.get(key)
        if oc is None:
            oc = _OfferingCount(price=self._lookup_price(pool, key))
            npc.offerings[key] = oc
        oc.count += 1
        npc.cost += oc.price
        self._claims[name] = (pool, key)

    def delete_node_claim(self, name: str) -> None:
        entry = self._claims.pop(name, None)
        if entry is None:
            return
        pool, key = entry
        npc = self._pools.get(pool)
        if npc is None or key not in npc.offerings:
            self._record_error(pool)
            return
        oc = npc.offerings[key]
        oc.count -= 1
        npc.cost -= oc.price
        if oc.count == 0:
            del npc.offerings[key]
        if not npc.offerings:
            del self._pools[pool]

    def delete_node_pool(self, pool: str) -> None:
        self._claims = {n: (p, k) for n, (p, k) in self._claims.items() if p != pool}
        self._pools.pop(pool, None)
        self._price_index.pop(pool, None)

    # -- price refresh (cost.go:128-157) ---------------------------------------
    def update_offerings(self, node_pool, instance_types) -> None:
        """Re-price active offerings after catalog/pricing changes."""
        prices = _build_price_index(instance_types)
        self._price_index[node_pool.metadata.name] = prices
        npc = self._pools.get(node_pool.metadata.name)
        if npc is None:
            return
        cost = 0.0
        for key, oc in npc.offerings.items():
            if key in prices:
                oc.price = prices[key]
            cost += oc.count * oc.price
        npc.cost = cost

    # -- totals ----------------------------------------------------------------
    def get_cluster_cost(self) -> float:
        return sum(npc.cost for npc in self._pools.values())

    def get_nodepool_cost(self, pool: str) -> float:
        npc = self._pools.get(pool)
        return npc.cost if npc is not None else 0.0

    def reset(self) -> None:
        self._pools = {}
        self._claims = {}
        self._price_index = {}

    def _lookup_price(self, pool: str, key: tuple[str, str, str]) -> float:
        """O(1) from the per-pool price index, built lazily on first lookup and
        refreshed by update_offerings."""
        index = self._price_index.get(pool)
        if index is None:
            np_ = self.store.try_get("NodePool", pool)
            if np_ is None:
                return 0.0
            index = _build_price_index(self.cloud_provider.get_instance_types(np_))
            self._price_index[pool] = index
        return index.get(key, 0.0)


class PricingController:
    """Periodic offering-price refresh feeding ClusterCost.

    Reference: pkg/controllers/state/informer/pricing.go:44-70 — re-reads every
    pool's instance types from the cloud provider and re-prices active
    offerings, so catalog/price changes (including NodeOverlay adjustments)
    reach the cost totals.
    """

    POLL_SECONDS = 60.0

    def __init__(self, store, cloud_provider, cluster_cost: "ClusterCost", clock):
        self.store = store
        self.cloud_provider = cloud_provider
        self.cluster_cost = cluster_cost
        self.clock = clock
        self._last_run = -1e18

    def reconcile(self, force: bool = False) -> None:
        now = self.clock.now()
        if not force and now - self._last_run < self.POLL_SECONDS:
            return
        self._last_run = now
        for np_ in self.store.list("NodePool"):
            its = self.cloud_provider.get_instance_types(np_)
            self.cluster_cost.update_offerings(np_, its)


def start_cost_informer(store, cluster_cost: ClusterCost) -> None:
    """Feed ClusterCost from store watch events, the way the reference's
    nodeclaim/nodepool informers do (informer/nodeclaim.go:69-79,
    informer/nodepool.go:68)."""

    def on_node_claim(event: str, nc) -> None:
        if event == "DELETED":
            cluster_cost.delete_node_claim(nc.metadata.name)
        else:
            cluster_cost.update_node_claim(nc)

    def on_node_pool(event: str, np_) -> None:
        if event == "DELETED":
            cluster_cost.delete_node_pool(np_.metadata.name)

    store.watch("NodeClaim", on_node_claim)
    store.watch("NodePool", on_node_pool)
    for nc in store.list("NodeClaim"):
        cluster_cost.update_node_claim(nc)
