"""Runtime validation of NodePool specs.

Reference: pkg/apis/v1/nodepool_validation.go:27-58 (RuntimeValidate =
labels + taints + requirements + nodepool-key-absent) and
nodeclaim_validation.go:66-160 (taint + requirement field validation).
Returns a list of error strings; empty means valid.
"""

from __future__ import annotations

import re

from ..scheduling.requirements import Operator
from . import labels as wk

SUPPORTED_OPERATORS = {op.value for op in Operator}

_QUALIFIED_NAME = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")
_LABEL_VALUE = re.compile(r"^([A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?)?$")
_DNS_SUBDOMAIN = re.compile(r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?$")

TAINT_EFFECTS = {"NoSchedule", "PreferNoSchedule", "NoExecute", ""}


def is_qualified_name(key: str) -> bool:
    """k8s qualified name: optional dns-subdomain prefix '/' + name <=63 chars."""
    if "/" in key:
        prefix, name = key.split("/", 1)
        if not prefix or len(prefix) > 253 or not _DNS_SUBDOMAIN.match(prefix):
            return False
    else:
        name = key
    return bool(name) and len(name) <= 63 and bool(_QUALIFIED_NAME.match(name))


def is_valid_label_value(value: str) -> bool:
    return len(value) <= 63 and bool(_LABEL_VALUE.match(value))


def validate_labels(labels: dict[str, str]) -> list[str]:
    errs = []
    for key, value in labels.items():
        if key == wk.NODEPOOL_LABEL_KEY:
            errs.append(f"invalid key name {key!r} in labels, restricted")
        if not is_qualified_name(key):
            errs.append(f"invalid key name {key!r} in labels, not a qualified name")
        if not is_valid_label_value(value):
            errs.append(f"invalid value {value!r} for label[{key}]")
        if wk.is_restricted(key):
            errs.append(f"invalid key name {key!r} in labels, restricted domain")
    return errs


def validate_taints(taints: list, startup_taints: list) -> list[str]:
    errs: list[str] = []
    existing: set[tuple[str, str]] = set()
    for field_name, ts in (("taints", taints), ("startupTaints", startup_taints)):
        for t in ts:
            if not t.key:
                errs.append(f"empty taint key in {field_name}")
            elif not is_qualified_name(t.key):
                errs.append(f"invalid taint key {t.key!r} in {field_name}")
            if t.value and not is_valid_label_value(t.value):
                errs.append(f"invalid taint value {t.value!r} in {field_name}")
            if t.effect not in TAINT_EFFECTS:
                errs.append(f"invalid taint effect {t.effect!r} in {field_name}")
            pair = (t.key, t.effect)
            if pair in existing:
                errs.append(f"duplicate taint Key/Effect pair {t.key}={t.effect}")
            existing.add(pair)
    return errs


def validate_requirement(req: dict) -> list[str]:
    """One NodeSelectorRequirementWithMinValues (nodeclaim_validation.go:118-160)."""
    errs = []
    key = wk.normalize_key(req.get("key", ""))
    op = req.get("operator", "")
    values = req.get("values", []) or []
    min_values = req.get("minValues")
    if op not in SUPPORTED_OPERATORS:
        errs.append(f"key {key} has an unsupported operator {op}")
    if wk.is_restricted(key):
        errs.append(f"label {key} is restricted")
    if not is_qualified_name(key):
        errs.append(f"key {key} is not a qualified name")
    for v in values:
        if not is_valid_label_value(v):
            errs.append(f"invalid value {v} for key {key}")
    if op == "In" and not values:
        errs.append(f"key {key} with operator In must have a value defined")
    if op == "In" and min_values is not None and len(values) < min_values:
        errs.append(f"key {key} with operator In must have at least minValues values")
    if op in ("Gt", "Lt"):
        ok = len(values) == 1 and values[0].isdigit()
        if not ok:
            errs.append(f"key {key} with operator {op} must have a single positive integer value")
    return errs


def runtime_validate(nodepool) -> list[str]:
    """nodepool_validation.go:28-31 RuntimeValidate."""
    t = nodepool.spec.template
    errs = validate_labels(t.labels)
    errs += validate_taints(t.taints, t.startup_taints)
    for req in t.requirements:
        errs += validate_requirement(req)
        if req.get("key") == wk.NODEPOOL_LABEL_KEY:
            errs.append(f"invalid key {wk.NODEPOOL_LABEL_KEY!r} in requirements, restricted")
    return errs
