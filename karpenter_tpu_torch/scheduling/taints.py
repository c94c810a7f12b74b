"""Taints and tolerations (reference: pkg/scheduling/taints.go).

A pod fails against a node iff some NoSchedule/NoExecute taint is untolerated.
The contract is SPLIT on PreferNoSchedule: scheduler-flavored callers
(candidate checks, topology domain reachability) treat it as blocking until
relaxation adds a toleration (include_prefer_no_schedule=True); kubelet-
flavored callers (binder, daemon materialization, drain) never block on it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str = NO_SCHEDULE
    value: str = ""

    def to_dict(self) -> dict:
        return {"key": self.key, "value": self.value, "effect": self.effect}

    @classmethod
    def from_dict(cls, d: dict) -> "Taint":
        return cls(key=d["key"], effect=d.get("effect", NO_SCHEDULE), value=d.get("value", ""))


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: int | None = field(default=None, compare=False)

    def tolerates(self, taint: Taint) -> bool:
        """corev1.Toleration.ToleratesTaint semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value

    @classmethod
    def from_dict(cls, d: dict) -> "Toleration":
        return cls(
            key=d.get("key", ""),
            operator=d.get("operator", "Equal"),
            value=d.get("value", ""),
            effect=d.get("effect", ""),
            toleration_seconds=d.get("tolerationSeconds"),
        )


# taints expected while a node initializes; lifted by kubelet / readiness
# controllers, so scheduling and initialization both treat them as transient
# (reference scheduling/taints.go:35-52 KnownEphemeralTaints + key prefixes)
KNOWN_EPHEMERAL_TAINTS = frozenset(
    {
        ("node.kubernetes.io/not-ready", "NoSchedule"),
        ("node.kubernetes.io/not-ready", "NoExecute"),
        ("node.kubernetes.io/unreachable", "NoSchedule"),
        ("node.cloudprovider.kubernetes.io/uninitialized", "NoSchedule"),
    }
)
KNOWN_EPHEMERAL_TAINT_KEY_PREFIXES = ("readiness.k8s.io/",)


def is_known_ephemeral_taint(taint: "Taint") -> bool:
    """taints.go IsKnownEphemeralTaint: exact (key, effect) families plus
    controller-suffixed key-prefix families, any effect."""
    return (taint.key, taint.effect) in KNOWN_EPHEMERAL_TAINTS or taint.key.startswith(
        KNOWN_EPHEMERAL_TAINT_KEY_PREFIXES
    )


def taints_tolerate_pod(taints: Iterable[Taint], pod, include_prefer_no_schedule: bool = False) -> str | None:
    """Error string naming the first untolerated taint, or None (reference:
    taints.go Taints.ToleratesPod). The SCHEDULER's candidate checks treat
    PreferNoSchedule as blocking until relaxation adds a toleration
    (scheduler.go:146-151 + preferences.go toleratePreferNoScheduleTaints);
    kubelet-flavored callers (binder, daemons, drain) ignore it."""
    tolerations = [t if isinstance(t, Toleration) else Toleration.from_dict(t) for t in (pod.spec.tolerations or ())]
    for taint in taints:
        if taint.effect == PREFER_NO_SCHEDULE and not include_prefer_no_schedule:
            continue
        if not any(tol.tolerates(taint) for tol in tolerations):
            return f"did not tolerate {taint.key}={taint.value}:{taint.effect}"
    return None


def pools_taint_prefer_no_schedule(node_pools) -> bool:
    """True when any pool's template carries a PreferNoSchedule taint — the
    condition that arms the toleration relaxation (scheduler.go:144-153)."""
    return any(t.effect == PREFER_NO_SCHEDULE for np in node_pools for t in np.spec.template.taints)


def merge_taints(existing: list[Taint], incoming: Iterable[Taint]) -> list[Taint]:
    """Add taints absent by (key, effect)."""
    have = {(t.key, t.effect) for t in existing}
    out = list(existing)
    for t in incoming:
        if (t.key, t.effect) not in have:
            out.append(t)
            have.add((t.key, t.effect))
    return out
