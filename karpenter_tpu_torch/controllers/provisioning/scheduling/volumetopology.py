"""Volume topology: PVC-derived node requirements for scheduling.

Reference: provisioning/scheduling/volumetopology.go — a pod's PVCs constrain
where it can run (a bound PV's node affinity, or a StorageClass's
AllowedTopologies for unbound WaitForFirstConsumer claims). Each OR'd term
becomes one *alternative* Requirements; for multi-volume pods the cross
product of per-volume alternatives is taken, preferring branches whose
requirements intersect (volumetopology.go:92-125).

The alternatives attach to node/claim requirements only — never to the pod's
own affinity — so topology-spread counting still uses the pod's original
constraints (volumetopology.go:62-64).
"""

from __future__ import annotations

from ....apis import labels as wk
from ....scheduling.requirements import Requirements
from ....scheduling.volumeusage import (
    BIND_COMPLETED_ANNOTATION,
    effective_storage_class_name,
    get_persistent_volume_claim,
    resolve_driver,
)

# Volume plugins / topology keys Karpenter cannot satisfy; pods referencing
# them are skipped (volumetopology.go:39-46).
UNSUPPORTED_PROVISIONERS: set[str] = set()
UNSUPPORTED_TOPOLOGY_KEYS: set[str] = set()


class VolumeTopology:
    def __init__(self, store):
        self.store = store

    def get_requirements(self, pod) -> list[Requirements]:
        """Volume topology requirement alternatives for the pod; empty list =
        unconstrained (volumetopology.go:65-90)."""
        alternatives: list = [None]
        for volume in pod.spec.volumes:
            vol_alts = self._volume_requirements(pod, volume)
            if not vol_alts:
                continue
            alternatives = _merge_alternatives(alternatives, vol_alts)
        if len(alternatives) == 1 and alternatives[0] is None:
            return []
        return [a if a is not None else Requirements() for a in alternatives]

    def _volume_requirements(self, pod, volume: dict) -> list[Requirements]:
        pvc, _ = get_persistent_volume_claim(self.store, pod, volume)
        if pvc is None:
            return []
        if pvc.volume_name:
            return self._persistent_volume_requirements(pvc.volume_name)
        sc_name = effective_storage_class_name(self.store, pvc)
        if sc_name:
            return self._storage_class_requirements(sc_name)
        return []

    def _storage_class_requirements(self, storage_class_name: str) -> list[Requirements]:
        """Each AllowedTopologies term is OR'd -> one alternative each
        (volumetopology.go:172-189)."""
        sc = self.store.try_get("StorageClass", storage_class_name)
        if sc is None:
            return []
        alternatives = []
        for term in sc.allowed_topologies:
            exprs = [{"key": e["key"], "operator": "In", "values": e.get("values", [])} for e in term]
            if exprs:
                alternatives.append(Requirements.from_node_selector_terms(exprs))
        return alternatives

    def _persistent_volume_requirements(self, volume_name: str) -> list[Requirements]:
        """Each PV nodeSelectorTerm is OR'd -> one alternative each; hostname
        affinity on Local/HostPath volumes is ignored since a replacement node
        can never carry the old hostname (volumetopology.go:191-222)."""
        pv = self.store.try_get("PersistentVolume", volume_name)
        if pv is None or not pv.node_affinity_required:
            return []
        alternatives = []
        for term in pv.node_affinity_required:
            exprs = term
            if pv.local or pv.host_path:
                exprs = [e for e in term if e.get("key") != wk.HOSTNAME_LABEL_KEY]
                if term and not exprs:
                    # hostname-only terms become unconstrained alternatives
                    alternatives.append(Requirements())
                    continue
            if exprs:
                alternatives.append(Requirements.from_node_selector_terms(exprs))
        return alternatives

    def validate_persistent_volume_claims(self, pod) -> str | None:
        """Pre-scheduling PVC validation mirroring what kube-scheduler rejects
        (volumetopology.go:227-289). Returns an error string to skip the pod."""
        for volume in pod.spec.volumes:
            pvc, _ = get_persistent_volume_claim(self.store, pod, volume)
            if pvc is None:
                # a named claim that doesn't exist (vs. a non-PVC volume type)
                # blocks scheduling
                name = (volume.get("persistentVolumeClaim") or {}).get("claimName")
                if name:
                    return f"persistentvolumeclaim {name} not found"
                continue
            if pvc.metadata.deletion_timestamp is not None:
                return f"persistentvolumeclaim {pvc.key()} is being deleted"
            if pvc.phase == "Lost":
                return f"persistentvolumeclaim {pvc.key()} bound to non-existent persistentvolume"
            if pvc.volume_name:
                err = self._validate_volume(pvc.volume_name)
                if err is not None:
                    return err
                # bound-with-volumeName claims must carry the bind-completed
                # annotation to count as bound (volumetopology.go:250-255)
                if BIND_COMPLETED_ANNOTATION not in pvc.metadata.annotations:
                    return f"pvc {pvc.key()} is considered unbound, missing {BIND_COMPLETED_ANNOTATION}"
            else:
                sc_name = effective_storage_class_name(self.store, pvc)
                if not sc_name:
                    return f"unbound pvc {pvc.key()} must define a storage class"
                sc = self.store.try_get("StorageClass", sc_name)
                if sc is None:
                    return f"storage class {sc_name} not found"
                if sc.volume_binding_mode == "Immediate":
                    return f"pvc {pvc.key()} with immediate volume binding mode must be bound"
                for term in sc.allowed_topologies:
                    for expr in term:
                        if expr.get("key") in UNSUPPORTED_TOPOLOGY_KEYS:
                            return f"storage class {sc.metadata.name} uses unsupported topology key {expr.get('key')}"
            driver = resolve_driver(self.store, pvc)
            if driver in UNSUPPORTED_PROVISIONERS:
                return f"provisioner {driver} is not supported"
        return None

    def _validate_volume(self, volume_name: str) -> str | None:
        pv = self.store.try_get("PersistentVolume", volume_name)
        if pv is None:
            return f"persistentvolume {volume_name} not found"
        if pv.metadata.deletion_timestamp is not None:
            return f"persistentvolume {volume_name} is being deleted"
        return None


def _merge_alternatives(alternatives: list, vol_alts: list) -> list:
    """Cross-product preferring compatible branches; fall back to the full
    product when every branch conflicts (volumetopology.go:92-125)."""
    compatible = [
        _merge_pair(existing, vol)
        for existing in alternatives
        for vol in vol_alts
        if _pair_compatible(existing, vol)
    ]
    if compatible:
        return compatible
    return [_merge_pair(existing, vol) for existing in alternatives for vol in vol_alts]


def _pair_compatible(existing, vol) -> bool:
    if existing is None or vol is None:
        return True
    return existing.intersects(vol) is None


def _merge_pair(existing, vol) -> Requirements:
    merged = Requirements()
    if existing is not None:
        merged.add(*existing.values())
    if vol is not None:
        merged.add(*vol.values())
    return merged
