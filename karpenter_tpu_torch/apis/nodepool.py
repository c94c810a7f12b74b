"""NodePool API type, disruption policy surface, and budget math.

Reference: pkg/apis/v1/nodepool.go:42-171 (spec: Template, Disruption, Limits,
Weight, Replicas; Budget cron windows; consolidation policies incl. Balanced
with k=2) and nodepool.go:352-430 (allowed-disruptions math).
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Optional

from ..kube.objects import ObjectMeta
from ..scheduling.taints import Taint
from ..utils.durations import Cron, parse_duration
from ..utils.quantity import Quantity
from .conditions import ConditionSet

# Consolidation policies (nodepool.go:160-171)
WHEN_EMPTY = "WhenEmpty"
WHEN_EMPTY_OR_UNDERUTILIZED = "WhenEmptyOrUnderutilized"
BALANCED = "Balanced"

# Balanced scoring parameter (nodepool.go:171 BalancedK = 2): a move passes
# when savings%/disruption% >= 1/k.
BALANCED_K = 2

# Disruption reasons for budgets (nodepool.go:186-193)
REASON_UNDERUTILIZED = "Underutilized"
REASON_EMPTY = "Empty"
REASON_DRIFTED = "Drifted"

COND_NODEPOOL_VALIDATION_SUCCEEDED = "ValidationSucceeded"
COND_NODE_REGISTRATION_HEALTHY = "NodeRegistrationHealthy"
COND_NODEPOOL_READY = "Ready"


@dataclass
class Budget:
    """Max NodeClaims of a pool terminating at once; optionally cron-windowed
    (nodepool.go:119-157)."""

    nodes: str = "10%"  # int string or percentage
    reasons: Optional[list[str]] = None  # None = all reasons
    schedule: Optional[str] = None  # cron, UTC
    duration: Optional[str] = None  # go duration string

    def is_active(self, now: float) -> tuple[bool, str | None]:
        if self.schedule is None and self.duration is None:
            return True, None
        if self.schedule is None or self.duration is None:
            return False, "schedule must be set with duration"
        try:
            cron = Cron(self.schedule)
            dur = parse_duration(self.duration)
        except ValueError as e:
            return False, str(e)
        return cron.active_within(now, dur), None

    def allowed_disruptions(self, now: float, num_nodes: int) -> tuple[int, str | None]:
        """Scaled allowed count; rounds percentages UP like PDB MaxUnavailable
        (nodepool.go:382-404). Misconfigured budgets fail closed."""
        active, err = self.is_active(now)
        if err is not None:
            return 0, err
        if not active:
            return 2**31 - 1, None
        if self.nodes.endswith("%"):
            try:
                pct = int(self.nodes[:-1])
            except ValueError:
                return 0, f"invalid budget nodes {self.nodes!r}"
            return math.ceil(pct * num_nodes / 100), None
        try:
            return int(self.nodes), None
        except ValueError:
            return 0, f"invalid budget nodes {self.nodes!r}"


@dataclass
class Disruption:
    consolidate_after: Optional[str] = "0s"  # duration or "Never"
    consolidation_policy: str = WHEN_EMPTY_OR_UNDERUTILIZED
    budgets: list[Budget] = field(default_factory=lambda: [Budget()])

    def consolidate_after_seconds(self) -> float:
        d = parse_duration(self.consolidate_after) if self.consolidate_after is not None else 0.0
        return d if d is not None else 0.0


@dataclass
class NodeClaimTemplate:
    """Template of possibilities for launched NodeClaims (nodepool.go:204-270)."""

    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    taints: list[Taint] = field(default_factory=list)
    startup_taints: list[Taint] = field(default_factory=list)
    requirements: list[dict] = field(default_factory=list)  # {key, operator, values, minValues?}
    node_class_ref: dict = field(default_factory=lambda: {"group": "karpenter.kwok.sh", "kind": "KWOKNodeClass", "name": "default"})
    termination_grace_period: Optional[str] = None
    expire_after: Optional[str] = "720h"


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplate = field(default_factory=NodeClaimTemplate)
    disruption: Disruption = field(default_factory=Disruption)
    limits: dict[str, Quantity] = field(default_factory=dict)
    weight: int = 0  # higher = scheduled first; 1..100
    replicas: Optional[int] = None  # static-capacity pools


@dataclass
class NodePoolStatus:
    resources: dict[str, Quantity] = field(default_factory=dict)
    node_count: int = 0
    conditions: ConditionSet = field(default_factory=ConditionSet)


@dataclass
class NodePool:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)
    status: NodePoolStatus = field(default_factory=NodePoolStatus)
    kind: str = "NodePool"

    def key(self) -> str:
        return self.metadata.name

    def is_static(self) -> bool:
        return self.spec.replicas is not None

    # -- budgets ---------------------------------------------------------------
    def allowed_disruptions(self, now: float, num_nodes: int, reason: str) -> int:
        """Most-restrictive active budget for the reason; errors fail closed
        (nodepool.go:352-377 MustGetAllowedDisruptions)."""
        allowed = 2**31 - 1
        for budget in self.spec.disruption.budgets:
            val, err = budget.allowed_disruptions(now, num_nodes)
            if err is not None:
                return 0
            if budget.reasons is None or reason in budget.reasons:
                allowed = min(allowed, val)
        return allowed

    # -- drift hash ------------------------------------------------------------
    def hash(self) -> str:
        """Static drift hash over the template fields the reference hashes
        (requirements are hash:"ignore" — nodepool.go:238)."""
        t = self.spec.template
        payload = {
            "labels": t.labels,
            "annotations": t.annotations,
            "taints": [vars(x) if not isinstance(x, dict) else x for x in t.taints],
            "startupTaints": [vars(x) if not isinstance(x, dict) else x for x in t.startup_taints],
            "nodeClassRef": t.node_class_ref,
            "terminationGracePeriod": t.termination_grace_period,
            "expireAfter": t.expire_after,
        }
        return hashlib.sha256(json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()[:16]

    def limits_exceeded_by(self, usage: dict[str, Quantity]) -> str | None:
        """Error if usage exceeds any configured limit (nodepool.go Limits.ExceededBy)."""
        for name, used in usage.items():
            lim = self.spec.limits.get(name)
            if lim is not None and used.milli > lim.milli:
                return f"resource {name} usage {used} exceeds limit {lim}"
        return None
