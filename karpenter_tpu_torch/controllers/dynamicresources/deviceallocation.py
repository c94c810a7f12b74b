"""Device-allocation controller: persist DRA allocations to ResourceClaim
status.

Reference: pkg/controllers/dynamicresources/deviceallocation/controller.go —
the scheduler's in-memory device decisions become durable by writing
status.allocation (devices + node) and status.reservedFor onto the
ResourceClaims of bound pods; claims whose reserving pods are gone get
released so their devices free up.
"""

from __future__ import annotations

from ...scheduling.dynamicresources import Allocator, resolve_pod_claims
from ...utils import pods as pod_utils


class DeviceAllocationController:
    def __init__(self, store, cluster, clock):
        self.store = store
        self.cluster = cluster
        self.clock = clock

    def reconcile(self) -> None:
        self._allocate_for_bound_pods()
        self._release_orphaned_claims()

    def _allocate_for_bound_pods(self) -> None:
        allocator = None
        for pod in self.store.list("Pod"):
            if not pod.spec.resource_claims or not pod.spec.node_name or not pod_utils.is_active(pod):
                continue
            claims, err = resolve_pod_claims(self.store, pod)
            if err is not None:
                continue
            for rc in claims:
                stored = self.store.try_get("ResourceClaim", rc.metadata.name, rc.metadata.namespace)
                if stored is not None and stored.status.allocation:
                    self._ensure_reserved(stored, pod)
                    continue
                if allocator is None:
                    allocator = Allocator(self.store, self.clock)
                result, aerr = allocator.allocate_for_node(pod.spec.node_name, [rc])
                if aerr is not None:
                    continue
                allocator.commit_for_node(pod.spec.node_name, result)
                self._write_allocation(rc, pod, result)

    def _write_allocation(self, rc, pod, result) -> None:
        devices = [
            {
                "request": name,
                "driver": ref.driver,
                "pool": ref.pool,
                "device": ref.device.name,
                **({"consumedCapacity": cap} if cap else {}),
                **({"multiAllocatable": True} if ref.device.allow_multiple_allocations else {}),
            }
            for name, ref, cap in result.picks.get(rc.key(), [])
        ]
        stored = self.store.try_get("ResourceClaim", rc.metadata.name, rc.metadata.namespace)
        if stored is None:
            # template-derived claim materializes on first allocation
            rc.status.allocation = {"nodeName": pod.spec.node_name, "devices": devices}
            rc.status.reserved_for = [pod.metadata.uid]
            self.store.create(rc)
            return

        def apply(obj):
            obj.status.allocation = {"nodeName": pod.spec.node_name, "devices": devices}
            if pod.metadata.uid not in obj.status.reserved_for:
                obj.status.reserved_for.append(pod.metadata.uid)

        self.store.patch("ResourceClaim", rc.metadata.name, apply, namespace=rc.metadata.namespace)

    def _ensure_reserved(self, rc, pod) -> None:
        if pod.metadata.uid in rc.status.reserved_for:
            return

        def apply(obj):
            if pod.metadata.uid not in obj.status.reserved_for:
                obj.status.reserved_for.append(pod.metadata.uid)

        self.store.patch("ResourceClaim", rc.metadata.name, apply, namespace=rc.metadata.namespace)

    def _release_orphaned_claims(self) -> None:
        active_uids = {p.metadata.uid for p in self.store.list("Pod") if pod_utils.is_active(p)}
        for rc in self.store.list("ResourceClaim"):
            if not rc.status.allocation and not rc.status.reserved_for:
                continue
            still = [uid for uid in rc.status.reserved_for if uid in active_uids]
            if still == rc.status.reserved_for:
                continue

            def apply(obj, still=still):
                obj.status.reserved_for = list(still)
                if not still:
                    obj.status.allocation = None  # devices free up

            self.store.patch("ResourceClaim", rc.metadata.name, apply, namespace=rc.metadata.namespace)
