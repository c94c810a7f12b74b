"""NodeOverlay CRD: price/capacity overrides applied to instance types during
scheduling simulation.

Reference: pkg/apis/v1alpha1/nodeoverlay.go:59-140 — spec carries selector
requirements (supporting the extra Gte/Lte operators), exactly one of
price / priceAdjustment, extended-resource capacity additions, and a weight
for precedence; OrderByWeight sorts heavier overlays first with
reverse-alphabetical name tiebreak (nodeoverlay.go:126-140).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..kube.objects import ObjectMeta
from ..utils.quantity import Quantity
from . import labels as wk
from . import validation
from .conditions import ConditionSet

COND_VALIDATION_SUCCEEDED = "ValidationSucceeded"

# Standard resources an overlay may NOT add/override (nodeoverlay.go:87,
# nodeoverlay_validation.go:49-56): capacity is extended-resources only.
RESTRICTED_CAPACITY_RESOURCES = frozenset({"cpu", "memory", "ephemeral-storage", "pods"})

OVERLAY_OPERATORS = frozenset({"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt", "Gte", "Lte"})


@dataclass
class NodeOverlaySpec:
    # [{key, operator, values}] — may use Gte/Lte in addition to the pod ops
    requirements: list[dict] = field(default_factory=list)
    # "+0.1" / "-10%" style delta, or None
    price_adjustment: str | None = None
    # absolute price override, or None (mutually exclusive with adjustment)
    price: str | None = None
    # extended resources appended to matching instance types
    capacity: dict[str, Quantity] = field(default_factory=dict)
    # precedence: higher wins; equal weights merge alphabetically
    weight: int = 0


@dataclass
class NodeOverlayStatus:
    conditions: ConditionSet = field(default_factory=ConditionSet)


@dataclass
class NodeOverlay:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeOverlaySpec = field(default_factory=NodeOverlaySpec)
    status: NodeOverlayStatus = field(default_factory=NodeOverlayStatus)
    kind: str = "NodeOverlay"

    def runtime_validate(self) -> list[str]:
        """nodeoverlay_validation.go:30-56 RuntimeValidate."""
        errs = []
        if self.spec.price is not None and self.spec.price_adjustment is not None:
            errs.append("cannot set both 'price' and 'priceAdjustment'")
        # format checks mirror the CRD CEL patterns (nodeoverlay.go:70,80):
        # price is a plain non-negative decimal; priceAdjustment is a signed
        # decimal or signed percentage
        if self.spec.price is not None and not _is_decimal(self.spec.price):
            errs.append(f"invalid price {self.spec.price!r}, must be a non-negative decimal")
        if self.spec.price_adjustment is not None:
            adj = self.spec.price_adjustment
            body = adj[:-1] if adj.endswith("%") else adj
            if not (body.startswith(("+", "-")) and _is_decimal(body[1:])):
                errs.append(f"invalid priceAdjustment {self.spec.price_adjustment!r}, must be signed decimal or percentage")
        for req in self.spec.requirements:
            op = req.get("operator", "")
            if op not in OVERLAY_OPERATORS:
                errs.append(f"key {req.get('key')} has an unsupported operator {op}")
                continue
            if op in ("Gt", "Lt", "Gte", "Lte"):
                values = req.get("values", []) or []
                if len(values) != 1 or not values[0].isdigit():
                    errs.append(f"key {req.get('key')} with operator {op} must have a single positive integer value")
                continue
            errs += validation.validate_requirement(req)
            if op == "NotIn" and not (req.get("values") or []):
                errs.append(f"key {req.get('key')} with operator NotIn must have a value defined")
        for res_name in self.spec.capacity:
            if res_name in RESTRICTED_CAPACITY_RESOURCES:
                errs.append(f"invalid capacity: {res_name} in resource, restricted")
        return errs


def _is_decimal(s: str) -> bool:
    # exact CRD CEL pattern (nodeoverlay.go:70,80): ASCII digits with an
    # optional fractional part, no surrounding whitespace — float() parsing
    # would admit "1e5", "1_000", "1.", " 1 ", and Unicode digits
    return re.fullmatch(r"[0-9]+(\.[0-9]+)?", s) is not None


def order_by_weight(overlays: list[NodeOverlay]) -> list[NodeOverlay]:
    """Heavier first; equal weights ordered by name reverse-alphabetically so
    merging at equal weight is deterministic (nodeoverlay.go:126-140)."""
    by_name = sorted(overlays, key=lambda o: o.metadata.name, reverse=True)
    return sorted(by_name, key=lambda o: o.spec.weight, reverse=True)  # stable
