"""KWOKNodeClass CRD (reference: kwok/apis/v1alpha1) — provider-specific
config for the in-tree KWOK cloud, incl. the registration delay used by
chaos/e2e tests."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..kube.objects import ObjectMeta
from .conditions import ConditionSet


@dataclass
class KWOKNodeClassSpec:
    node_registration_delay: float = 0.0  # seconds before the Node object appears


@dataclass
class KWOKNodeClassStatus:
    conditions: ConditionSet = field(default_factory=ConditionSet)


@dataclass
class KWOKNodeClass:
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(name="default"))
    spec: KWOKNodeClassSpec = field(default_factory=KWOKNodeClassSpec)
    status: KWOKNodeClassStatus = field(default_factory=KWOKNodeClassStatus)
    kind: str = "KWOKNodeClass"
