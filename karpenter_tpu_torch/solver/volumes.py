"""PVC-backed volumes on the tensor path (the common case).

Reference semantics: provisioning/scheduling/volumetopology.go (PVC-derived
node requirement alternatives) + scheduling/volumeusage.go (per-driver CSI
attach limits). The host oracle handles the full surface; the tensor window
covers the dominant real-world shape and lowers it to existing encode
machinery:

- a pod whose PVCs yield exactly ONE topology alternative (dynamic
  WaitForFirstConsumer provisioning, or a bound PV with a single node-affinity
  term) folds that alternative into the pod's requirement mask — semantically
  equal to the host's per-claim alternative loop when there is no branching
  (nodeclaim.py _try_volume_alternative with one entry);
- per-driver attach demand becomes synthetic resource axes
  ("csi-att:<driver>": one unit per distinct PVC), with existing-node
  capacity = CSINode limit minus attached count and new-claim capacity
  unbounded (the host oracle tracks limits only on existing nodes —
  ExistingNode.can_add exceeds_limits; SchedulingNodeClaim does not);
- anything outside the window (multi-alternative topology, a PVC shared
  between solve pods or already attached on a node — the host counts DISTINCT
  claim ids where the additive axis would double-count, or volume topology
  touching a key the pod also spreads on — the host attaches volume
  requirements to the node only, never to spread counting,
  volumetopology.go:62-64) falls back to the host FFD.

Resolution uses borrowed store reads and per-solve memos so a 50k-pod solve
with 20% PVC pods stays inside the <1s north star.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..apis import labels as wk
from ..scheduling.requirements import Requirements
from ..scheduling.volumeusage import IN_TREE_TO_CSI, csi_driver_name as _csi_name, effective_storage_class_name

CSI_AXIS_PREFIX = "csi-att:"
CSI_AXIS_BIG = 1e9  # "no limit" capacity on the scaled resource axis


@dataclass
class VolComponent:
    """Resolved volume constraint of one pod."""

    fingerprint: tuple
    requirements: Requirements | None  # the single folded alternative
    drivers: tuple  # sorted ((driver, distinct-claim count), ...)
    pvc_ids: frozenset
    reason: str | None = None  # out-of-window reason, if any

    def req_keys(self) -> set[str]:
        return set(self.requirements.keys()) if self.requirements is not None else set()


@dataclass
class VolumeLowering:
    """Per-solve resolver with memoized PVC/SC/PV lookups (borrowed reads)."""

    store: object
    _sc_alts: dict = field(default_factory=dict)  # sc name -> (fp, reqs|None, driver, reason|None)
    _pv_alts: dict = field(default_factory=dict)  # pv name -> (fp, reqs|None, driver, reason|None)

    def component(self, pod) -> VolComponent | None:
        """None when the pod has no PVC-backed volumes."""
        reqs: Requirements | None = None
        fp_parts: list = []
        driver_counts: dict[str, set] = {}
        pvc_ids: list[str] = []
        reason = None
        for volume in pod.spec.volumes:
            pvc = self._resolve_claim(pod, volume)
            if pvc is None:
                continue
            pvc_key = f"{pvc.metadata.namespace}/{pvc.metadata.name}"
            pvc_ids.append(pvc_key)
            if pvc.volume_name:
                fp, vol_reqs, driver, vreason = self._bound_pv(pvc.volume_name)
            else:
                sc_name = self._effective_sc_name(pvc)
                fp, vol_reqs, driver, vreason = self._storage_class(sc_name)
            if vreason is not None and reason is None:
                reason = vreason
            fp_parts.append(fp)
            if driver:
                driver_counts.setdefault(driver, set()).add(pvc_key)
            if vol_reqs is not None:
                merged = Requirements()
                if reqs is not None:
                    merged.add(*reqs.values())
                merged.add(*vol_reqs.values())
                reqs = merged
        if not pvc_ids:
            return None
        drivers = tuple(sorted((d, len(ids)) for d, ids in driver_counts.items()))
        return VolComponent(
            fingerprint=(tuple(fp_parts), drivers),
            requirements=reqs,
            drivers=drivers,
            pvc_ids=frozenset(pvc_ids),
            reason=reason,
        )

    # -- leaf resolution: reuses the volumeusage.py helpers (one copy of the
    # ephemeral-claim and default-SC rules) with borrowed reads ---------------
    def _resolve_claim(self, pod, volume: dict):
        from ..scheduling.volumeusage import get_persistent_volume_claim

        pvc, _ = get_persistent_volume_claim(self.store, pod, volume, get=self.store.borrow_get)
        return pvc

    def _effective_sc_name(self, pvc) -> str | None:
        return effective_storage_class_name(self.store, pvc)

    def _storage_class(self, sc_name: str | None):
        """(fingerprint, reqs|None, driver, reason|None) for an unbound PVC.
        Fingerprints are content-keyed via resourceVersion: the decode caches
        (tpu.py req_cache/mask_cache) key on them across solves, so a
        recreated/edited StorageClass must never alias its old fold."""
        if not sc_name:
            return ("sc", None), None, "", None
        hit = self._sc_alts.get(sc_name)
        if hit is not None:
            return hit
        sc = self.store.borrow_get("StorageClass", sc_name)
        if sc is None:
            out = (("sc", sc_name, -1), None, "", None)  # host: unconstrained
        else:
            fp = ("sc", sc_name, sc.metadata.resource_version)
            terms = [t for t in sc.allowed_topologies if t]
            if len(terms) > 1:
                out = (fp, None, _csi_name(sc.provisioner), "pvc multi-alternative topology")
            elif terms:
                exprs = [{"key": e["key"], "operator": "In", "values": e.get("values", [])} for e in terms[0]]
                out = (fp, Requirements.from_node_selector_terms(exprs), _csi_name(sc.provisioner), None)
            else:
                out = (fp, None, _csi_name(sc.provisioner), None)
        self._sc_alts[sc_name] = out
        return out

    def _bound_pv(self, volume_name: str):
        hit = self._pv_alts.get(volume_name)
        if hit is not None:
            return hit
        pv = self.store.borrow_get("PersistentVolume", volume_name)
        if pv is None:
            out = (("pv", volume_name, -1), None, "", None)
        else:
            fp = ("pv", volume_name, pv.metadata.resource_version)
            driver = pv.csi_driver or IN_TREE_TO_CSI.get(pv.in_tree_source, "")
            terms = pv.node_affinity_required
            if pv.local or pv.host_path:
                # hostname terms on local volumes never constrain replacements
                # (volumetopology.go:191-222); a term that filters to EMPTY is
                # an UNCONSTRAINED alternative in the host oracle
                # (volumetopology.py _persistent_volume_requirements) — since
                # alternatives are OR'd, one unconstrained alternative means
                # the volume never constrains the pod at all
                filtered = [[e for e in t if e.get("key") != wk.HOSTNAME_LABEL_KEY] for t in terms]
                terms = [] if any(not t for t in filtered) else filtered
            if len(terms) > 1:
                out = (fp, None, driver, "pvc multi-alternative topology")
            elif terms and terms[0]:
                out = (fp, Requirements.from_node_selector_terms(terms[0]), driver, None)
            else:
                out = (fp, None, driver, None)
        self._pv_alts[volume_name] = out
        return out


def has_pvc_volumes(pod) -> bool:
    return any(v.get("persistentVolumeClaim") or v.get("ephemeral") is not None for v in pod.spec.volumes)


def window_reasons(comp: VolComponent | None, pod) -> list[str]:
    """Per-pod out-of-window reasons for a resolved component."""
    if comp is None:
        return []
    out = []
    if comp.reason:
        out.append(f"{pod.key()}: {comp.reason}")
    if comp.requirements is not None:
        vol_keys = comp.req_keys()
        spread_keys = {t.topology_key for t in pod.spec.topology_spread_constraints}
        aff = pod.spec.affinity
        if aff is not None:
            spread_keys |= {t.topology_key for t in aff.pod_affinity_required}
            spread_keys |= {t.topology_key for t in aff.pod_anti_affinity_required}
        if vol_keys & spread_keys:
            # volume reqs bind the node only, never spread counting
            # (volumetopology.go:62-64) — folding into the pod mask would
            # change domain accounting for these keys
            out.append(f"{pod.key()}: volume topology overlaps spread key")
    return out


def existing_row_axis_value(sn, driver: str) -> float:
    """Remaining attach slots for `driver` on an existing node, in axis units
    (ExistingNode semantics: exceeds_limits against CSINode allocatable)."""
    remaining = sn.volume_usage.remaining(driver)
    return CSI_AXIS_BIG if remaining is None else float(remaining)
