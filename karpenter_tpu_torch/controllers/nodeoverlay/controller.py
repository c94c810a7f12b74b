"""NodeOverlay controller: validate overlays, build the overlay store, publish
it atomically.

Reference: pkg/controllers/nodeoverlay/controller.go:73-141 — one reconcile
evaluates every overlay against every NodePool's instance types in descending
weight order, detects equal-weight conflicts, writes ValidationSucceeded
status conditions, then swaps the published InstanceTypeStore and marks the
cluster unconsolidated so scheduling sees the new prices.
"""

from __future__ import annotations

from ...apis import labels as wk
from ...apis.nodeoverlay import COND_VALIDATION_SUCCEEDED, order_by_weight
from ...scheduling.requirements import Requirement, Requirements
from .store import InstanceTypeStore, InternalInstanceTypeStore


class NodeOverlayController:
    def __init__(self, store, cloud_provider, instance_type_store: InstanceTypeStore, cluster, clock, options=None):
        self.store = store
        self.cloud_provider = cloud_provider
        self.instance_type_store = instance_type_store
        self.cluster = cluster
        self.clock = clock
        self.options = options
        self._dirty = True
        self._pool_spec_fingerprints: dict[str, str] = {}
        # overlay/nodepool churn re-triggers evaluation (controller.go:143-161
        # watches); everything else rides the periodic requeue
        store.watch("NodeOverlay", self._mark_dirty)
        store.watch("NodePool", self._on_node_pool)

    def _mark_dirty(self, event: str, obj) -> None:
        self._dirty = True

    def _on_node_pool(self, event: str, np_) -> None:
        # overlay matching reads only the pool spec (template labels etc.) —
        # status-only churn (e.g. the counter controller on every scale event)
        # must not re-trigger the O(pools × types × overlays) evaluation
        name = np_.metadata.name
        if event == "DELETED":
            self._pool_spec_fingerprints.pop(name, None)
            self._dirty = True
            return
        fp = repr(np_.spec)
        if self._pool_spec_fingerprints.get(name) != fp:
            self._pool_spec_fingerprints[name] = fp
            self._dirty = True

    def reconcile(self, force: bool = False) -> None:
        # the reference only registers this controller when the gate is on
        # (controllers.go:171-172)
        if self.options is not None and not self.options.feature_gates.node_overlay:
            return
        if not force and not self._dirty:
            return
        self._dirty = False

        overlays = order_by_weight(self.store.list("NodeOverlay"))
        node_pools = self.store.list("NodePool")
        pool_instance_types = {}
        for np_ in node_pools:
            its = self.cloud_provider.get_instance_types(np_)
            if its:
                pool_instance_types[np_.metadata.name] = its
        evaluated = [np_ for np_ in node_pools if np_.metadata.name in pool_instance_types]

        temp = InternalInstanceTypeStore()
        validation_failures: dict[str, str] = {}
        conflicts: set[str] = set()
        for overlay in overlays:
            errs = overlay.runtime_validate()
            if errs:
                validation_failures[overlay.metadata.name] = "; ".join(errs)
                continue
            if not self._validate_and_update(temp, evaluated, pool_instance_types, overlay):
                conflicts.add(overlay.metadata.name)
        temp.evaluated_node_pools.update(np_.metadata.name for np_ in evaluated)

        now = self.clock.now()
        for overlay in overlays:
            name = overlay.metadata.name
            if name in validation_failures:
                desired = ("False", "RuntimeValidation", validation_failures[name])
            elif name in conflicts:
                desired = ("False", "Conflict", "conflict with another overlay")
            else:
                desired = ("True", COND_VALIDATION_SUCCEEDED, "")
            cur = overlay.status.conditions.get(COND_VALIDATION_SUCCEEDED)
            # patch only on transition — an unconditional patch would fire our
            # own NodeOverlay watch and re-dirty this controller every tick
            if cur is not None and (cur.status, cur.reason, cur.message) == desired:
                continue

            def set_status(o, desired=desired):
                o.status.conditions.set(COND_VALIDATION_SUCCEEDED, desired[0], desired[1], desired[2], now=now)

            self.store.patch("NodeOverlay", name, set_status)

        # publish; wake consolidation only when the effective overlays changed
        changed = self.instance_type_store.publish_if_changed(temp)
        if changed:
            self.cluster.mark_unconsolidated()

    # -- evaluation (controller.go:163-224) ------------------------------------
    def _validate_and_update(self, temp, node_pools, pool_instance_types, overlay) -> bool:
        """Two-phase: validate against every pool first so an invalid overlay
        is never partially applied, then store (controller.go:173-180)."""
        for np_ in node_pools:
            if not self._validate_pool(temp, np_, pool_instance_types[np_.metadata.name], overlay):
                return False
        for np_ in node_pools:
            self._store_pool(temp, np_, pool_instance_types[np_.metadata.name], overlay)
        return True

    def _overlay_requirements(self, overlay) -> Requirements:
        return Requirements.from_node_selector_terms(overlay.spec.requirements)

    def _overlaid_offerings(self, np_, it, overlay_reqs: Requirements) -> list:
        """Offerings the overlay selects on this instance type, or [] when the
        overlay does not select the type at all (controller.go:226-245)."""
        it_reqs = Requirements(Requirement(wk.NODEPOOL_LABEL_KEY, "In", [np_.metadata.name]))
        it_reqs.add(*Requirements.from_labels(np_.spec.template.labels).values())
        it_reqs.add(*it.requirements.values())
        if not it_reqs.is_compatible(overlay_reqs):
            return []
        return [o for o in it.offerings if overlay_reqs.intersects(o.requirements) is None]

    def _validate_pool(self, temp, np_, its, overlay) -> bool:
        overlay_reqs = self._overlay_requirements(overlay)
        has_price = overlay.spec.price is not None or overlay.spec.price_adjustment is not None
        for it in its:
            offerings = self._overlaid_offerings(np_, it, overlay_reqs)
            if not offerings:
                continue
            if has_price and any(
                temp.is_offering_update_conflicting(np_.metadata.name, it.name, o, overlay) for o in offerings
            ):
                return False
            if overlay.spec.capacity and temp.is_capacity_update_conflicting(np_.metadata.name, it.name, overlay):
                return False
        return True

    def _store_pool(self, temp, np_, its, overlay) -> None:
        overlay_reqs = self._overlay_requirements(overlay)
        for it in its:
            offerings = self._overlaid_offerings(np_, it, overlay_reqs)
            if not offerings:
                continue
            temp.update_instance_type_offering(np_.metadata.name, it.name, overlay, offerings)
            temp.update_instance_type_capacity(np_.metadata.name, it.name, overlay)
