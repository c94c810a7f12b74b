"""CapacityBuffer controller: resolve pod shape + target replicas into status.

Reference: capacitybuffer/controller.go:69-245 + helpers.go — resolves
podTemplateRef or scalableRef to a pod spec, derives the replica count
(max(replicas, percentage-of-workload), bounded by resource limits; limits
alone size the buffer when neither is set), and publishes ReadyForProvisioning
so the provisioner can inject virtual pods.
"""

from __future__ import annotations

import copy
import math

from ...apis.capacitybuffer import (
    BUFFER_NAME_LABEL,
    BUFFER_NAMESPACE_LABEL,
    COND_READY_FOR_PROVISIONING,
    FAKE_POD_ANNOTATION_KEY,
    FAKE_POD_ANNOTATION_VALUE,
    VIRTUAL_POD_PRIORITY,
)
from ...kube.objects import ObjectMeta, Pod, PodCondition, PodStatus
from ...utils import resources as res

SCALABLE_KINDS = ("Deployment", "ReplicaSet", "StatefulSet")


RECONCILE_SECONDS = 30.0  # controller.go:102 RequeueAfter


class CapacityBufferController:
    def __init__(self, store, clock, provisioner=None):
        self.store = store
        self.clock = clock
        self.provisioner = provisioner  # triggered after successful resolve
        self._last_run = -1e18

    def reconcile(self) -> None:
        # 30s cadence matching the reference's requeue: each pass re-resolves
        # status and re-triggers a provisioning pass, which is also what
        # refreshes buffer-pod counts after buffers shrink or disappear. New
        # buffers (no condition yet) are resolved immediately, like the
        # watch-driven reconcile on create.
        now = self.clock.now()
        buffers = self.store.list("CapacityBuffer")
        fresh = any(cb.status.conditions.get(COND_READY_FOR_PROVISIONING) is None for cb in buffers)
        if now - self._last_run < RECONCILE_SECONDS and not fresh:
            return
        self._last_run = now
        for cb in buffers:
            self._reconcile_buffer(cb)

    def _reconcile_buffer(self, cb) -> None:
        resolved = self._resolve_and_update_status(cb)
        cb.status.provisioning_strategy = cb.spec.provisioning_strategy
        self.store.update_status(cb)
        if resolved and self.provisioner is not None:
            self.provisioner.trigger(cb.metadata.uid)

    def _resolve_and_update_status(self, cb) -> bool:
        """controller.go:142-178 resolveAndUpdateStatus."""
        now = self.clock.now()
        errs = cb.runtime_validate()
        if errs:
            cb.status.conditions.set_false(COND_READY_FOR_PROVISIONING, "ResolutionFailed", "; ".join(errs), now=now)
            return False
        candidates: list[int] = []
        if cb.spec.pod_template_ref is not None:
            pt = self.store.try_get("PodTemplate", cb.spec.pod_template_ref, cb.metadata.namespace)
            if pt is None:
                cb.status.conditions.set_false(
                    COND_READY_FOR_PROVISIONING, "PodTemplateNotFound",
                    f"podtemplate {cb.spec.pod_template_ref} not found", now=now,
                )
                return False
            pod_spec = pt.template_spec
            cb.status.pod_template_ref = pt.metadata.name
            cb.status.pod_template_generation = pt.metadata.generation
        elif cb.spec.scalable_ref is not None:
            ref = cb.spec.scalable_ref
            if ref.kind not in SCALABLE_KINDS:
                cb.status.conditions.set_false(
                    COND_READY_FOR_PROVISIONING, "ResolutionFailed",
                    f"unsupported scalableRef kind {ref.kind}", now=now,
                )
                return False
            workload = self.store.try_get(ref.kind, ref.name, cb.metadata.namespace)
            if workload is None:
                cb.status.conditions.set_false(
                    COND_READY_FOR_PROVISIONING, "ScalableRefNotFound",
                    f"{ref.kind.lower()} {ref.name} not found", now=now,
                )
                return False
            pod_spec = workload.template_spec
            cb.status.pod_template_ref = None
            cb.status.pod_template_generation = None
            if cb.spec.percentage is not None and workload.replicas > 0:
                candidates.append(_percentage_replicas(workload.replicas, cb.spec.percentage))
        else:
            cb.status.conditions.set_false(
                COND_READY_FOR_PROVISIONING, "ResolutionFailed",
                "neither podTemplateRef nor scalableRef is set", now=now,
            )
            return False

        cb.status.replicas = _compute_replicas(cb, pod_spec, candidates)
        cb.status.conditions.set_true(COND_READY_FOR_PROVISIONING, "Resolved", now=now)
        return True


def _compute_replicas(cb, pod_spec, candidates: list[int]) -> int:
    """replicas/percentage combine by MAX; limits bound by MIN, or size the
    buffer alone when neither is set (controller.go:181-208)."""
    if cb.spec.replicas is not None:
        candidates.append(cb.spec.replicas)
    desired = max(candidates) if candidates else 0
    if cb.spec.limits and pod_spec is not None:
        limit_replicas = _limit_replicas(cb.spec.limits, pod_spec)
        if limit_replicas is not None:
            return min(desired, limit_replicas) if candidates else limit_replicas
    return desired


def _limit_replicas(limits: dict, pod_spec) -> int | None:
    """floor(limit/request) minimized over overlapping resources
    (helpers.go:29-57); None when limits constrain nothing."""
    shim = Pod(spec=pod_spec)
    requests = res.pod_requests(shim)
    best = None
    for name, limit in limits.items():
        req = requests.get(name)
        if req is None or req.milli == 0:
            continue
        n = int(limit.milli // req.milli)
        best = n if best is None else min(best, n)
    return best


def _percentage_replicas(scalable_replicas: int, percentage: int) -> int:
    """ceil(replicas x pct / 100); positive inputs always yield >= 1
    (helpers.go:59-67)."""
    return math.ceil(scalable_replicas * percentage / 100.0)


def resolve_buffer_pod_spec(store, cb):
    """(pod spec, template labels) behind a buffer, read from spec (not
    status) so flipping between ref kinds never serves a stale shape
    (buffers.go:92-109). Returns (None, None) when the ref is dangling."""
    if cb.spec.pod_template_ref is not None:
        pt = store.try_get("PodTemplate", cb.spec.pod_template_ref, cb.metadata.namespace)
        if pt is None:
            return None, None
        return pt.template_spec, dict(pt.template_metadata.labels)
    if cb.spec.scalable_ref is not None:
        w = store.try_get(cb.spec.scalable_ref.kind, cb.spec.scalable_ref.name, cb.metadata.namespace)
        if w is None:
            return None, None
        return w.template_spec, dict(w.template_metadata.labels)
    return None, None


def build_virtual_pods(cb, pod_spec, template_labels: dict | None = None) -> list:
    """N placeholder pods with deterministic names/uids; PVC-backed volumes are
    stripped (no real PVC will ever exist for them) and priority is pinned
    below every real pod (buffers.go:114-189). Template labels ride along so
    spread constraints / anti-affinity selecting the workload's own labels
    shape the headroom the way real replicas would."""
    count = cb.status.replicas or 0
    if count <= 0:
        return []
    spec = copy.deepcopy(pod_spec)
    spec.node_name = ""
    spec.priority = VIRTUAL_POD_PRIORITY
    spec.volumes = [v for v in spec.volumes if not (v.get("persistentVolumeClaim") or v.get("ephemeral") is not None)]
    labels = {
        **(template_labels or {}),
        BUFFER_NAME_LABEL: cb.metadata.name,
        BUFFER_NAMESPACE_LABEL: cb.metadata.namespace,
    }
    out = []
    for i in range(1, count + 1):
        out.append(
            Pod(
                metadata=ObjectMeta(
                    name=f"capacity-buffer-{cb.metadata.name}-{i}",
                    namespace=cb.metadata.namespace,
                    uid=f"{cb.metadata.uid}-{i}",
                    annotations={FAKE_POD_ANNOTATION_KEY: FAKE_POD_ANNOTATION_VALUE},
                    labels=dict(labels),
                ),
                spec=copy.deepcopy(spec),
                status=PodStatus(
                    phase="Pending",
                    conditions=[PodCondition(type="PodScheduled", status="False", reason="Unschedulable")],
                ),
            )
        )
    return out
