"""InstanceType / Offering model and the CloudProvider interface.

Reference: pkg/cloudprovider/types.go — the 9-method interface (types.go:73-101),
InstanceType{Name, Requirements, Offerings, Capacity, Overhead} (types.go:123-142),
Offering{Requirements, Price, Available, ReservationCapacity} (types.go:470-486),
price ordering (types.go:336) and allocatable precompute (types.go:202-295).

This model is the main input of the TPU solver: each InstanceType lowers to one
row of the type-axis tensors (allocatable vector, label-value ids, price per
offering) in karpenter_tpu/solver/encode.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Protocol, Sequence

from ..apis import labels as wk
from ..scheduling.requirements import Requirement, Requirements
from ..utils import resources as res
from ..utils.quantity import Quantity


@dataclass
class Offering:
    """A (zone, capacity-type[, reservation]) sellable unit of an instance type."""

    requirements: Requirements
    price: float
    available: bool = True
    reservation_capacity: int = 0  # for reserved offerings
    capacity_override: Optional[dict[str, Quantity]] = None
    overhead_override: Optional["InstanceTypeOverhead"] = None
    price_overlaid: bool = False

    def capacity_type(self) -> str:
        return self.requirements.get(wk.CAPACITY_TYPE_LABEL_KEY).any()

    def zone(self) -> str:
        return self.requirements.get(wk.ZONE_LABEL_KEY).any()

    def reservation_id(self) -> str:
        r = self.requirements
        key = f"{wk.GROUP}/reservation-id"
        return r.get(key).any() if r.has(key) else ""

    def apply_price_overlay(self, adjustment: str, absolute: bool | None = None) -> None:
        """NodeOverlay price adjustment: absolute ("1.5"), delta ("+0.1"/"-0.1"),
        or percentage ("+10%"/"-10%") — types.go:488-527 AdjustedPrice."""
        self.price = adjusted_price(self.price, adjustment, absolute)
        self.price_overlaid = True


def adjusted_price(price: float, change: str, absolute: bool | None = None) -> float:
    """`absolute` disambiguates which overlay field the change came from
    (price vs priceAdjustment); a "+1.5" absolute price must override, not
    add. None falls back to format sniffing for callers without that context."""
    change = change.strip()
    if absolute is True:
        return max(float(change), 0.0)
    if change.endswith("%"):
        pct = float(change[:-1])
        return max(price * (1 + pct / 100.0), 0.0)
    if change.startswith(("+", "-")) or absolute is False:
        return max(price + float(change), 0.0)
    return max(float(change), 0.0)


@dataclass
class InstanceTypeOverhead:
    """Reserved resources deducted from capacity (types.go:452-463)."""

    kube_reserved: dict[str, Quantity] = field(default_factory=dict)
    system_reserved: dict[str, Quantity] = field(default_factory=dict)
    eviction_threshold: dict[str, Quantity] = field(default_factory=dict)

    def total(self) -> dict[str, Quantity]:
        return res.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


@dataclass
class InstanceType:
    name: str
    requirements: Requirements
    offerings: list[Offering] = field(default_factory=list)
    capacity: dict[str, Quantity] = field(default_factory=dict)
    overhead: InstanceTypeOverhead = field(default_factory=InstanceTypeOverhead)
    capacity_overlaid: bool = False
    # DRA template devices this instance type ships when launched
    # (reference types.go:133-135 DynamicResources); [kube.objects.Device]
    dynamic_resources: list = field(default_factory=list)
    # template-pool shared counter sets the devices above consume from — each
    # LAUNCHED node gets its own fresh budget (reference
    # cloudprovider/dynamicresources.go ResourceSliceTemplate.SharedCounters)
    # [{"name": str, "counters": {counter name: Quantity|str}}]
    dynamic_resources_counters: list = field(default_factory=list)

    _allocatable: Optional[dict[str, Quantity]] = field(default=None, repr=False, compare=False)
    _alloc_groups: Optional[list] = field(default=None, repr=False, compare=False)

    def compute_allocatable(
        self,
        capacity_override: Optional[dict[str, Quantity]] = None,
        overhead_override: Optional["InstanceTypeOverhead"] = None,
    ) -> dict[str, Quantity]:
        """(capacity ⊕ override) − (overhead ⊕ override), hugepage
        reservations subtracted from memory, floored at zero
        (types.go:261-295 computeAllocatable)."""
        capacity = self.capacity
        if capacity_override:
            capacity = {**self.capacity, **capacity_override}
        overhead = self.overhead.total()
        if overhead_override is not None:
            overhead = {**overhead, **overhead_override.total()}
        out = res.subtract(capacity, overhead)
        out = {k: (v if v.milli > 0 else Quantity(0)) for k, v in out.items()}
        huge = sum(q.milli for k, q in capacity.items() if k.startswith("hugepages-"))
        if huge:
            mem = out.get("memory", Quantity(0)).milli - huge
            out["memory"] = Quantity(max(mem, 0))
        return out

    def allocatable(self) -> dict[str, Quantity]:
        """Base allocatable: no offering overrides (types.go:330-334)."""
        if self._allocatable is None:
            self._allocatable = self.compute_allocatable()
        return self._allocatable

    def allocatable_offerings_list(self) -> list[tuple[dict[str, Quantity], list[Offering]]]:
        """Groups of (allocatable, available offerings producing it); the
        first entry is always the base allocatable, override offerings are
        grouped by identical override content (types.go:202-257 precompute +
        groupOfferingsByOverride). Availability is read live: tests and
        overlays flip o.available in place, so the cache keys on the
        availability vector and rebuilds when it changes."""
        avail_key = tuple(o.available for o in self.offerings)
        if self._alloc_groups is not None and self._alloc_groups[0] != avail_key:
            self._alloc_groups = None
        if self._alloc_groups is None:
            base: list[Offering] = []
            order: list[tuple] = []
            by_key: dict[tuple, list[Offering]] = {}
            for o in self.offerings:
                if not o.available:
                    continue
                if not o.capacity_override and o.overhead_override is None:
                    base.append(o)
                    continue
                key = (
                    tuple(sorted((k, v.milli) for k, v in (o.capacity_override or {}).items())),
                    repr(o.overhead_override),
                )
                if key not in by_key:
                    by_key[key] = []
                    order.append(key)
                by_key[key].append(o)
            groups: list[tuple[dict[str, Quantity], list[Offering]]] = [
                (self.allocatable(), base)
            ]
            for key in order:
                offs = by_key[key]
                groups.append(
                    (self.compute_allocatable(offs[0].capacity_override, offs[0].overhead_override), offs)
                )
            self._alloc_groups = (avail_key, groups)
        return self._alloc_groups[1]

    def apply_capacity_overlay(self, updated: dict[str, Quantity]) -> None:
        self.capacity = res.merge(self.capacity, updated)  # overlay adds/overrides
        for k, v in updated.items():
            self.capacity[k] = v
        self.capacity_overlaid = True
        self._allocatable = None
        self._alloc_groups = None

    def offering_price(self, zone: str, capacity_type: str) -> Optional[float]:
        for o in self.offerings:
            if o.zone() == zone and o.capacity_type() == capacity_type:
                return o.price
        return None

    def available_offerings(self) -> list[Offering]:
        return [o for o in self.offerings if o.available]

    def is_compatible(self, reqs: Requirements) -> bool:
        return self.requirements.intersects(reqs) is None


# -- Offerings ops (types.go:544-597) -----------------------------------------

def offerings_compatible(offerings: Iterable[Offering], reqs: Requirements) -> list[Offering]:
    return [o for o in offerings if reqs.intersects(o.requirements) is None]


def offerings_available(offerings: Iterable[Offering]) -> list[Offering]:
    return [o for o in offerings if o.available]


def cheapest(offerings: Sequence[Offering]) -> Optional[Offering]:
    return min(offerings, key=lambda o: o.price, default=None)


def most_expensive(offerings: Sequence[Offering]) -> Optional[Offering]:
    return max(offerings, key=lambda o: o.price, default=None)


def worst_launch_price(offerings: Sequence[Offering], reqs: Requirements) -> float:
    """Highest price among offerings of the capacity type we would launch with;
    precedence reserved > spot > on-demand (types.go:585-597)."""
    compat = offerings_compatible(offerings, reqs)
    for ct in (wk.CAPACITY_TYPE_RESERVED, wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND):
        sub = [o for o in compat if o.capacity_type() == ct]
        if sub:
            return max(o.price for o in sub)
    return 0.0


# -- InstanceTypes ops ---------------------------------------------------------

def order_by_price(its: Iterable[InstanceType], reqs: Requirements) -> list[InstanceType]:
    """Sort by cheapest compatible+available offering price (types.go:336-356)."""

    def price_of(it: InstanceType) -> float:
        best = float("inf")
        for o in it.offerings:
            if o.available and reqs.intersects(o.requirements) is None and o.price < best:
                best = o.price
        return best

    return sorted(its, key=price_of)


def compatible_instance_types(its: Iterable[InstanceType], reqs: Requirements) -> list[InstanceType]:
    """Filter to types whose requirements intersect reqs (types.go:358-397)."""
    return [it for it in its if it.is_compatible(reqs)]


def satisfies_min_values(its: Sequence[InstanceType], reqs: Requirements) -> tuple[int, dict[str, int] | None]:
    """Check requirement minValues flexibility over the instance-type set.

    Returns (min number of instance types needed, None) when satisfied, or
    (-1, {key: observed distinct values}) when unsatisfiable (types.go:399-435).
    """
    if not reqs.has_min_values():
        return 0, None
    value_sets: dict[str, set[str]] = {}
    # number of types needed: scan types in order, tracking when all minValues satisfied
    needed = 0
    satisfied_at: dict[str, int] = {}
    min_reqs = {k: r for k, r in reqs.items() if r.min_values is not None}
    for i, it in enumerate(its):
        for key, r in min_reqs.items():
            if it.requirements.has(key):
                v = it.requirements.get(key)
                vals = value_sets.setdefault(key, set())
                before = len(vals)
                vals.update(x for x in v.values if r.has(x))
                if len(vals) >= r.min_values and key not in satisfied_at and len(vals) != before:
                    satisfied_at[key] = i + 1
                elif len(vals) >= r.min_values and key not in satisfied_at:
                    satisfied_at[key] = i + 1
        if len(satisfied_at) == len(min_reqs):
            needed = max(satisfied_at.values())
            break
    unsat = {k: len(value_sets.get(k, ())) for k, r in min_reqs.items() if len(value_sets.get(k, ())) < r.min_values}
    if unsat:
        return -1, unsat
    return needed, None


def truncate_instance_types(its: list[InstanceType], reqs: Requirements, max_items: int) -> list[InstanceType]:
    """Keep the max_items cheapest while preserving minValues satisfiability
    (types.go:437-450). Caller must pass price-ordered types."""
    if len(its) <= max_items:
        return its
    out = its[:max_items]
    needed, unsat = satisfies_min_values(out, reqs)
    if unsat:
        raise ValueError(f"truncating to {max_items} types violates minValues: {unsat}")
    return out


@dataclass
class RepairPolicy:
    """Unhealthy-node force-repair window (types.go:62-71)."""

    condition_type: str
    condition_status: str
    toleration_duration: float  # seconds


class CloudProvider(Protocol):
    """The 9-method SPI (types.go:73-101). Implementations: kwok, fake."""

    def create(self, node_claim): ...
    def delete(self, node_claim) -> None: ...
    def get(self, provider_id: str): ...
    def list(self) -> list: ...
    def get_instance_types(self, node_pool) -> list[InstanceType]: ...
    def is_drifted(self, node_claim) -> str: ...
    def repair_policies(self) -> list[RepairPolicy]: ...
    def name(self) -> str: ...
    def get_supported_node_classes(self) -> list[str]: ...
