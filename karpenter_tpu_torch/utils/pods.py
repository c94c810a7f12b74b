"""Pod predicates (reference: pkg/utils/pod/scheduling.go).

The provisioner acts on "provisionable" pods: pending, unbound, and not
destined for termination. Reschedulability feeds disruption decisions.
"""

from __future__ import annotations

from .disruption import DO_NOT_DISRUPT_ANNOTATION

TERMINAL_PHASES = ("Succeeded", "Failed")


def is_scheduled(pod) -> bool:
    return bool(pod.spec.node_name)


def is_terminal(pod) -> bool:
    return pod.status.phase in TERMINAL_PHASES


def is_terminating(pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_provisionable(pod) -> bool:
    """Unbound, non-terminal, not terminating — the pods the provisioner batches."""
    return not is_scheduled(pod) and not is_terminal(pod) and not is_terminating(pod)


def is_active(pod) -> bool:
    return not is_terminal(pod) and not is_terminating(pod)


def is_reschedulable(pod) -> bool:
    """Pods that must fit elsewhere if their node is disrupted: active — or
    TERMINATING but owned by a StatefulSet, whose replacement is recreated
    with the same identity only after deletion, so reserving capacity for it
    raises availability (pod/scheduling.go:40-51) — and not owned by the
    node itself (static/mirror pods) or a DaemonSet."""
    return (
        (is_active(pod) or (is_owned_by_statefulset(pod) and is_terminating(pod)))
        and not is_owned_by_daemonset(pod)
        and not is_owned_by_node(pod)
    )


def is_owned_by_statefulset(pod) -> bool:
    return any(ref.kind == "StatefulSet" for ref in pod.metadata.owner_references)


def is_owned_by_daemonset(pod) -> bool:
    return any(ref.kind == "DaemonSet" for ref in pod.metadata.owner_references)


def is_owned_by_node(pod) -> bool:
    return any(ref.kind == "Node" for ref in pod.metadata.owner_references)


def has_do_not_disrupt(pod, now: float | None = None) -> bool:
    """Clock-aware do-not-disrupt check (reference pod/scheduling.go
    IsDoNotDisruptActive:205-240): "true" blocks forever; a positive Go
    duration ("5m", "1h") blocks until pod creation + duration; anything else
    — including "Never", which is NOT a valid Go duration and errors in the
    reference's time.ParseDuration — is treated as if the annotation were
    absent. `now=None` treats duration annotations as active (callers without
    a clock stay conservative)."""
    value = pod.metadata.annotations.get(DO_NOT_DISRUPT_ANNOTATION)
    if value is None:
        return False
    if value == "true":
        return True
    from .durations import NEVER, parse_duration

    try:
        seconds = parse_duration(value)
    except ValueError:
        return False  # invalid format: treated as absent
    if seconds is None or seconds <= 0 or seconds == NEVER:
        return False  # "Never" parses here (consolidateAfter-ism) but is an
        # invalid annotation duration in the reference: non-blocking
    if now is None:
        return True
    return now < (pod.metadata.creation_timestamp or 0.0) + seconds


def is_disruptable(pod, now: float | None = None) -> bool:
    return not has_do_not_disrupt(pod, now)


def is_eviction_blocked(pod, now: float | None = None) -> bool:
    return has_do_not_disrupt(pod, now) and is_active(pod)


def term_namespaces(pod, term, all_namespaces) -> set:
    """The namespaces a PodAffinityTerm selects: explicit list > selector
    (empty selector = ALL namespaces, approximated by `all_namespaces()`, a
    callable yielding every currently-known namespace; non-empty selectors
    approximate to the pod's own) > the pod's own namespace. Shared by the
    host topology tracker and the Binder so their term scoping can't drift."""
    if term.namespaces:
        return set(term.namespaces)
    if term.namespace_selector is not None:
        if not term.namespace_selector:
            return set(all_namespaces()) | {pod.metadata.namespace}
        return {pod.metadata.namespace}
    return {pod.metadata.namespace}
