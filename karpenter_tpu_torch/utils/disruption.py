"""Eviction/disruption cost model (reference: pkg/utils/disruption/disruption.go:36-88)."""

from __future__ import annotations

from ..apis.labels import DO_NOT_DISRUPT_ANNOTATION_KEY as DO_NOT_DISRUPT_ANNOTATION

PD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


def eviction_cost(pod) -> float:
    """Base 1.0, shifted by pod-deletion-cost annotation and priority, clamped
    to [-10, 10]."""
    cost = 1.0
    raw = pod.metadata.annotations.get(PD_DELETION_COST_ANNOTATION)
    if raw is not None:
        try:
            cost += float(raw) / 2.0**27
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += pod.spec.priority / 2.0**25
    return max(-10.0, min(10.0, cost))


def rescheduling_cost(pods) -> float:
    return sum(eviction_cost(p) for p in pods)


def lifetime_remaining(now: float, expire_after: float | None, created_at: float) -> float:
    """Fraction of node lifetime remaining in [0,1]; scales disruption cost
    toward zero as a node approaches expiry."""
    if not expire_after or expire_after == float("inf"):
        return 1.0
    age = now - created_at
    return max(0.0, min(1.0, (expire_after - age) / expire_after))
