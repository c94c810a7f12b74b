"""Per-node CSI volume usage and limits (reference: pkg/scheduling/volumeusage.go).

The number of volumes a node can attach varies by CSI driver (published via
CSINode allocatable counts); scheduling must track per-driver PVC counts so a
pod whose volumes would exceed a driver's limit is not placed on that node.

`Volumes` maps a storage driver name to the set of PVC ids it backs
(volumeusage.go:45-81); `VolumeUsage` aggregates per-pod Volumes against
per-driver limits (volumeusage.go:187-226).
"""

from __future__ import annotations

import weakref

BIND_COMPLETED_ANNOTATION = "pv.kubernetes.io/bind-completed"

Volumes = dict  # driver name -> set[str] of "namespace/name" PVC ids


def volumes_union(a: Volumes, b: Volumes) -> Volumes:
    out: Volumes = {k: set(v) for k, v in a.items()}
    for k, v in b.items():
        out.setdefault(k, set()).update(v)
    return out


def get_persistent_volume_claim(store, pod, volume: dict, get=None):
    """Resolve a pod volume to its PVC, handling generic ephemeral volumes
    (utils/volume: ephemeral PVC is named <pod>-<volume>). For an ephemeral
    volume whose PVC the ephemeral controller hasn't created yet, a synthetic
    claim is derived from the volumeClaimTemplate so its StorageClass topology
    still constrains scheduling. Returns (pvc | None, err | None); a deleted
    PVC yields (None, None) so state tracking never wedges on it
    (volumeusage.go:88-94). `get` overrides the store lookup (e.g.
    store.borrow_get for read-only hot paths)."""
    if get is None:
        get = store.try_get
    if volume.get("persistentVolumeClaim"):
        name = volume["persistentVolumeClaim"].get("claimName")
        if not name:
            return None, None
        return get("PersistentVolumeClaim", name, pod.metadata.namespace), None
    if volume.get("ephemeral") is not None:
        name = f"{pod.metadata.name}-{volume.get('name', '')}"
        pvc = get("PersistentVolumeClaim", name, pod.metadata.namespace)
        if pvc is not None:
            return pvc, None
        from ..kube.objects import ObjectMeta, PersistentVolumeClaim

        template_spec = (volume["ephemeral"].get("volumeClaimTemplate") or {}).get("spec") or {}
        return (
            PersistentVolumeClaim(
                metadata=ObjectMeta(name=name, namespace=pod.metadata.namespace),
                storage_class_name=template_spec.get("storageClassName"),
            ),
            None,
        )
    return None, None  # emptyDir, hostPath, configMap, ...


DEFAULT_STORAGE_CLASS_ANNOTATION = "storageclass.kubernetes.io/is-default-class"

# default-StorageClass lookup cache, invalidated by store revision: the scan
# runs on hot paths (every pod event / PodData build), and Store.list deep-
# copies every object it returns
_default_sc_cache = weakref.WeakKeyDictionary()


def effective_storage_class_name(store, pvc) -> str | None:
    """The PVC's storageClassName with default-class semantics: None means
    the cluster default StorageClass applies; "" means dynamic provisioning
    is disabled (volumeusage.go:131-139 handles only the latter)."""
    if pvc.storage_class_name is not None:
        return pvc.storage_class_name or None
    rv = getattr(store, "_rv", None)
    cached = _default_sc_cache.get(store)
    if cached is not None and cached[0] == rv:
        return cached[1]
    name = None
    for sc in store.list("StorageClass"):
        if sc.metadata.annotations.get(DEFAULT_STORAGE_CLASS_ANNOTATION) == "true":
            name = sc.metadata.name
            break
    _default_sc_cache[store] = (rv, name)
    return name


# CSI migration: legacy in-tree plugin names resolve to their CSI driver so
# limit tracking keys on one name regardless of which API surface declared
# the volume (csi-translation-lib GetCSINameFromInTreeName, used at
# volumeusage.go:163)
IN_TREE_TO_CSI = {
    "kubernetes.io/aws-ebs": "ebs.csi.aws.com",
    "kubernetes.io/gce-pd": "pd.csi.storage.gke.io",
    "kubernetes.io/azure-disk": "disk.csi.azure.com",
    "kubernetes.io/azure-file": "file.csi.azure.com",
    "kubernetes.io/cinder": "cinder.csi.openstack.org",
    "kubernetes.io/vsphere-volume": "csi.vsphere.vmware.com",
    "kubernetes.io/portworx-volume": "pxd.portworx.com",
}


def csi_driver_name(provisioner: str) -> str:
    """CSI-migrate a legacy in-tree plugin name; non-in-tree names pass
    through unchanged (csi-translation-lib GetCSINameFromInTreeName)."""
    return IN_TREE_TO_CSI.get(provisioner, provisioner)


def resolve_driver(store, pvc, storage_class_name: str | None = None) -> str:
    """Storage driver name for a PVC: bound PV's CSI driver first (with
    in-tree sources CSI-migrated), else the StorageClass provisioner
    (migrated too) (volumeusage.go:116-181). "" = untracked."""
    if pvc.volume_name:
        pv = store.try_get("PersistentVolume", pvc.volume_name)
        if pv is None:
            return ""
        if pv.csi_driver:
            return pv.csi_driver
        return IN_TREE_TO_CSI.get(pv.in_tree_source, "")
    if storage_class_name is None:
        storage_class_name = effective_storage_class_name(store, pvc)
    if not storage_class_name:
        return ""
    sc = store.try_get("StorageClass", storage_class_name)
    if sc is None:
        return ""
    return csi_driver_name(sc.provisioner)


def get_volumes(store, pod) -> Volumes:
    """The pod's PVC-backed volumes grouped by storage driver
    (volumeusage.go:84-111)."""
    out: Volumes = {}
    for volume in pod.spec.volumes:
        pvc, _ = get_persistent_volume_claim(store, pod, volume)
        if pvc is None:
            continue
        driver = resolve_driver(store, pvc)
        if driver:
            out.setdefault(driver, set()).add(pvc.key())
    return out


class VolumeUsage:
    """Tracks attached-volume counts per storage driver on one node
    (volumeusage.go:187-226)."""

    def __init__(self):
        self._volumes: Volumes = {}
        self._pod_volumes: dict[str, Volumes] = {}  # pod key -> Volumes
        self._limits: dict[str, int] = {}  # driver -> max attachable

    def exceeds_limits(self, vols: Volumes) -> str | None:
        for driver, pvcs in volumes_union(self._volumes, vols).items():
            limit = self._limits.get(driver)
            if limit is not None and len(pvcs) > limit:
                return f"would exceed volume limit for {driver}: {len(pvcs)} > {limit}"
        return None

    def add_limit(self, storage_driver: str, value: int) -> None:
        self._limits[storage_driver] = value

    def add(self, pod_key: str, volumes: Volumes) -> None:
        if volumes:
            self._pod_volumes[pod_key] = volumes
            self._volumes = volumes_union(self._volumes, volumes)

    def remove(self, pod_key: str) -> None:
        if self._pod_volumes.pop(pod_key, None) is not None:
            # PVC ids can be shared across pods; rebuild from what remains
            self._volumes = {}
            for vols in self._pod_volumes.values():
                self._volumes = volumes_union(self._volumes, vols)

    def remaining(self, storage_driver: str) -> int | None:
        """Attach slots left for a driver; None = no limit registered."""
        limit = self._limits.get(storage_driver)
        if limit is None:
            return None
        return max(0, limit - len(self._volumes.get(storage_driver, ())))

    def attached_ids(self) -> set[str]:
        """All distinct attached claim ids across drivers."""
        out: set[str] = set()
        for vols in self._volumes.values():
            out |= vols
        return out

    def copy(self) -> "VolumeUsage":
        c = VolumeUsage()
        c._volumes = {k: set(v) for k, v in self._volumes.items()}
        c._pod_volumes = {p: {k: set(v) for k, v in vols.items()} for p, vols in self._pod_volumes.items()}
        c._limits = dict(self._limits)
        return c
