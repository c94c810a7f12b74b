"""Copy-on-write instance-type overlay store.

Reference: pkg/controllers/nodeoverlay/store.go — an atomically-swapped
snapshot mapping nodePool -> instanceType -> {per-offering price update,
capacity update}. Readers (the overlay CloudProvider decorator) apply it with
selective copying: requirements/overhead are shared, offerings and capacity
are copied only when actually overridden, so a 144-type catalog costs a
handful of allocations per overlaid type.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class UnevaluatedNodePoolError(Exception):
    """GetInstanceTypes asked for a pool the overlay controller has not yet
    evaluated (cloudprovider NewUnevaluatedNodePoolError) — callers treat this
    as 'no instance types yet', retried on the next reconcile."""

    def __init__(self, pool: str):
        super().__init__(f"nodepool {pool!r} not yet evaluated by the nodeoverlay controller")
        self.pool = pool


def _offering_key(offering):
    """Canonical, collision-free identity for an offering's requirements
    (repr would truncate long In lists)."""
    return tuple(
        sorted(
            (r.key, r.complement, tuple(sorted(r.values)), r.gte, r.lte)
            for r in offering.requirements.values()
        )
    )


@dataclass
class _PriceUpdate:
    # the winning overlay's price ("1.5") or adjustment ("+10%"), store.go:30-33
    update: str | None = None
    absolute: bool = False  # True = spec.price, False = spec.priceAdjustment
    lowest_weight: int = 0


@dataclass
class _CapacityUpdate:
    update: dict = field(default_factory=dict)
    lowest_weight_resources: dict = field(default_factory=dict)
    lowest_weight: int = 0


@dataclass
class _InstanceTypeUpdate:
    price: dict[tuple, _PriceUpdate] = field(default_factory=dict)  # offering key -> update
    capacity: _CapacityUpdate | None = None


class InternalInstanceTypeStore:
    """One immutable-once-published snapshot (store.go:100-110)."""

    def __init__(self):
        self.updates: dict[str, dict[str, _InstanceTypeUpdate]] = {}  # pool -> type -> update
        self.evaluated_node_pools: set[str] = set()

    # -- write path (controller only; descending-weight order assumed) ---------
    def update_instance_type_offering(self, pool: str, type_name: str, overlay, offerings) -> None:
        """store.go:240-265 — first (heaviest) overlay to claim an offering
        wins; later equal-weight claims only record the weight for conflict
        detection."""
        if overlay.spec.price is None and overlay.spec.price_adjustment is None:
            return
        absolute = overlay.spec.price is not None
        price = overlay.spec.price if absolute else overlay.spec.price_adjustment
        itu = self.updates.setdefault(pool, {}).setdefault(type_name, _InstanceTypeUpdate())
        for o in offerings:
            key = _offering_key(o)
            existing = itu.price.get(key)
            if existing is not None:
                existing.lowest_weight = overlay.spec.weight
                continue
            itu.price[key] = _PriceUpdate(update=price, absolute=absolute, lowest_weight=overlay.spec.weight)

    def is_offering_update_conflicting(self, pool: str, type_name: str, offering, overlay) -> bool:
        """store.go:267-286 — same weight touching an already-claimed offering."""
        itu = self.updates.get(pool, {}).get(type_name)
        if itu is None:
            return False
        existing = itu.price.get(_offering_key(offering))
        if existing is None:
            return False
        return existing.lowest_weight == overlay.spec.weight

    def update_instance_type_capacity(self, pool: str, type_name: str, overlay) -> None:
        """store.go:178-210 — per-resource first-writer-wins merge."""
        if not overlay.spec.capacity:
            return
        itu = self.updates.setdefault(pool, {}).setdefault(type_name, _InstanceTypeUpdate())
        if itu.capacity is None:
            itu.capacity = _CapacityUpdate(
                update=dict(overlay.spec.capacity),
                lowest_weight_resources=dict(overlay.spec.capacity),
                lowest_weight=overlay.spec.weight,
            )
            return
        for res_name, q in overlay.spec.capacity.items():
            if res_name not in itu.capacity.update:
                itu.capacity.update[res_name] = q
        # Track ALL resources claimed at the current (lowest-seen) weight tier,
        # merging when another overlay of the same weight lands, so a later
        # equal-weight overlay conflicts with ANY earlier same-weight claimant,
        # not just the immediately preceding one. (The reference replaces the
        # set here — store.go:207 — which misses non-adjacent conflicts.)
        if itu.capacity.lowest_weight == overlay.spec.weight:
            itu.capacity.lowest_weight_resources.update(overlay.spec.capacity)
        else:
            itu.capacity.lowest_weight_resources = dict(overlay.spec.capacity)
            itu.capacity.lowest_weight = overlay.spec.weight

    def is_capacity_update_conflicting(self, pool: str, type_name: str, overlay) -> bool:
        """store.go:212-236 — equal-weight overlays touching the same resource."""
        itu = self.updates.get(pool, {}).get(type_name)
        if itu is None or itu.capacity is None:
            return False
        if itu.capacity.lowest_weight != overlay.spec.weight:
            return False
        return any(r in itu.capacity.lowest_weight_resources for r in overlay.spec.capacity)

    # -- read path -------------------------------------------------------------
    def apply(self, pool: str, it):
        """Copy-on-write application (store.go:117-149)."""
        itu = self.updates.get(pool, {}).get(it.name)
        if itu is None:
            return it
        from ...cloudprovider.types import InstanceType, Offering

        out = InstanceType(
            name=it.name,
            requirements=it.requirements,  # shared — never modified
            overhead=it.overhead,  # shared — never modified
            capacity=it.capacity,
        )
        if itu.capacity is not None and itu.capacity.update:
            out.capacity = dict(it.capacity)
            out.apply_capacity_overlay(itu.capacity.update)
        if itu.price:
            offerings = []
            for o in it.offerings:
                pu = itu.price.get(_offering_key(o))
                if pu is None:
                    offerings.append(o)  # shared — not modified
                    continue
                copied = Offering(
                    requirements=o.requirements,  # shared — immutable
                    price=o.price,
                    available=o.available,
                    reservation_capacity=o.reservation_capacity,
                    # preserve allocatable-group identity (types.go
                    # AllocatableOfferings): dropping these would silently
                    # move the copy into the base group
                    capacity_override=o.capacity_override,
                    overhead_override=o.overhead_override,
                )
                copied.apply_price_overlay(pu.update, pu.absolute)
                offerings.append(copied)
            out.offerings = offerings
        else:
            out.offerings = it.offerings  # shared
        return out


class InstanceTypeStore:
    """The published pointer readers go through (store.go:45-89). CPython
    attribute assignment is atomic, giving the same swap semantics as the
    reference's atomic.Pointer."""

    def __init__(self):
        self._store = InternalInstanceTypeStore()

    def update_store(self, new_store: InternalInstanceTypeStore) -> None:
        self._store = new_store

    def publish_if_changed(self, new_store: InternalInstanceTypeStore) -> bool:
        """Swap and report whether the effective content differs from the
        previous snapshot (so callers can skip consolidation wakeups)."""
        old = self._store
        self._store = new_store
        return (
            old.updates != new_store.updates or old.evaluated_node_pools != new_store.evaluated_node_pools
        )

    def apply_all(self, pool: str, its: list) -> list:
        store = self._store
        if pool not in store.evaluated_node_pools:
            raise UnevaluatedNodePoolError(pool)
        if pool not in store.updates:
            return its
        return [store.apply(pool, it) for it in its]

    def apply(self, pool: str, it):
        store = self._store
        if pool not in store.evaluated_node_pools:
            raise UnevaluatedNodePoolError(pool)
        return store.apply(pool, it)

    def reset(self) -> None:
        self._store = InternalInstanceTypeStore()
