"""ResourceList arithmetic: Merge / Subtract / Fits and pod request extraction.

Mirrors the behavior of the reference's pkg/utils/resources/resources.go
(Merge, Subtract, Fits, RequestsForPods, Cmp) over plain dicts of
resource-name -> Quantity. These dicts are the host-side exact form; the
solver lowers them to dense float tensors (see karpenter_tpu/solver/encode.py).
"""

from __future__ import annotations

from typing import Iterable, Mapping

from .quantity import Quantity

# Canonical k8s resource names the framework treats specially.
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"

ResourceList = dict  # str -> Quantity


def parse_resource_list(d: Mapping[str, object] | None) -> ResourceList:
    return {k: Quantity.parse(v) for k, v in (d or {}).items()}


def merge(*lists: Mapping[str, Quantity] | None) -> ResourceList:
    """Sum resource lists key-wise (reference: resources.go Merge)."""
    out: ResourceList = {}
    for rl in lists:
        if not rl:
            continue
        for k, v in rl.items():
            out[k] = out.get(k, Quantity(0)) + v
    return out


def subtract(a: Mapping[str, Quantity], b: Mapping[str, Quantity] | None) -> ResourceList:
    """a - b key-wise; keys only in b appear negated (reference: resources.go Subtract)."""
    out: ResourceList = {k: Quantity(v.milli) for k, v in a.items()}
    for k, v in (b or {}).items():
        out[k] = out.get(k, Quantity(0)) - v
    return out


def fits(candidate: Mapping[str, Quantity], total: Mapping[str, Quantity]) -> bool:
    """True iff candidate <= total for every resource candidate requests.

    A resource absent from total is treated as zero capacity
    (reference: resources.go Fits -> Cmp <= 0 for each candidate entry).
    """
    for k, v in candidate.items():
        if v.milli > total.get(k, Quantity(0)).milli:
            return False
    return True


def any_exceeds(candidate: Mapping[str, Quantity], total: Mapping[str, Quantity]) -> list[str]:
    """Names of resources where candidate > total (for error reporting)."""
    return [k for k, v in candidate.items() if v.milli > total.get(k, Quantity(0)).milli]


def is_zero(rl: Mapping[str, Quantity]) -> bool:
    return all(v.is_zero() for v in rl.values())


def max_resources(*lists: Mapping[str, Quantity] | None) -> ResourceList:
    """Key-wise max (used for init-container request semantics)."""
    out: ResourceList = {}
    for rl in lists:
        if not rl:
            continue
        for k, v in rl.items():
            if k not in out or v.milli > out[k].milli:
                out[k] = Quantity(v.milli)
    return out


def pod_requests(pod) -> ResourceList:
    """Effective scheduling requests of a pod, sidecar-aware (KEP-753), plus
    overhead and an implicit pods:1.

    Matches k8s resourcehelper.PodRequests as used by the reference
    (resources.go:115-126): init containers run sequentially, but restartable
    ("sidecar") init containers keep running, so

        effective = max( sum(main) + sum(sidecars),
                         max over non-sidecar init i of
                           (request_i + sum(sidecars started before i)) )
    """
    main = merge(*[c.resources.get("requests", {}) for c in pod.spec.containers])
    sidecar_running: ResourceList = {}
    init_peak: ResourceList = {}
    for c in pod.spec.init_containers:
        req = c.resources.get("requests", {})
        if c.is_sidecar():
            sidecar_running = merge(sidecar_running, req)
        else:
            init_peak = max_resources(init_peak, merge(sidecar_running, req))
    out = max_resources(merge(main, sidecar_running), init_peak)
    if pod.spec.overhead:
        out = merge(out, pod.spec.overhead)
    out[PODS] = out.get(PODS, Quantity(0)) + Quantity.parse(1)
    return out


def pod_limits(pod) -> ResourceList:
    main = merge(*[c.resources.get("limits", {}) for c in pod.spec.containers])
    sidecar_running: ResourceList = {}
    init_peak: ResourceList = {}
    for c in pod.spec.init_containers:
        lim = c.resources.get("limits", {})
        if c.is_sidecar():
            sidecar_running = merge(sidecar_running, lim)
        else:
            init_peak = max_resources(init_peak, merge(sidecar_running, lim))
    return max_resources(merge(main, sidecar_running), init_peak)


def requests_for_pods(pods: Iterable) -> ResourceList:
    return merge(*[pod_requests(p) for p in pods])


def cmp_resources(a: Mapping[str, Quantity], b: Mapping[str, Quantity]) -> int:
    """-1 if a strictly fits in b on all keys with some slack, else comparison helper."""
    fits_ab = fits(a, b)
    fits_ba = fits(b, a)
    if fits_ab and not fits_ba:
        return -1
    if fits_ba and not fits_ab:
        return 1
    return 0


def to_float_dict(rl: Mapping[str, Quantity]) -> dict[str, float]:
    return {k: v.as_float() for k, v in rl.items()}


def fmt(rl: Mapping[str, Quantity]) -> str:
    return ", ".join(f"{k}: {v}" for k, v in sorted(rl.items()))
