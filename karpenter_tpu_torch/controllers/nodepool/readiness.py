"""NodePool readiness controller.

Reference: pkg/controllers/nodepool/readiness/controller.go:60-105 — mirrors
the referenced NodeClass's Ready condition onto the NodePool as
NodeClassReady: NotFound/Terminating/Unknown/False all block readiness.
"""

from __future__ import annotations

from ...apis.conditions import FALSE, TRUE
from ...apis.nodepool import COND_NODEPOOL_READY, COND_NODEPOOL_VALIDATION_SUCCEEDED

COND_NODECLASS_READY = "NodeClassReady"


class NodePoolReadinessController:
    def __init__(self, store, clock):
        self.store = store
        self.clock = clock

    def reconcile(self) -> None:
        for np in self.store.list("NodePool"):
            ref = np.spec.template.node_class_ref
            kind = ref["kind"] if isinstance(ref, dict) else ref.kind
            name = ref["name"] if isinstance(ref, dict) else ref.name
            node_class = self.store.try_get(kind, name)
            changed = self._set_conditions(np, node_class)
            if changed:
                self.store.update_status(np)

    def _set_conditions(self, np, node_class) -> bool:
        now = self.clock.now()
        conds = np.status.conditions
        if node_class is None:
            changed = conds.set_false(COND_NODECLASS_READY, "NodeClassNotFound", "NodeClass not found on cluster", now=now)
        elif node_class.metadata.deletion_timestamp is not None:
            changed = conds.set_false(COND_NODECLASS_READY, "NodeClassTerminating", "NodeClass is Terminating", now=now)
        else:
            ready = node_class.status.conditions.get("Ready")
            if ready is None:
                # node classes with no readiness machinery (KWOK) count ready
                changed = conds.set_true(COND_NODECLASS_READY, now=now)
            elif ready.status == TRUE:
                changed = conds.set_true(COND_NODECLASS_READY, now=now)
            elif ready.status == FALSE:
                changed = conds.set_false(COND_NODECLASS_READY, ready.reason, ready.message, now=now)
            else:
                changed = conds.set_false(COND_NODECLASS_READY, "NodeClassReadinessUnknown", "Node Class Readiness Unknown", now=now)
        # roll up the overall Ready condition from the per-aspect conditions
        aspects = [COND_NODECLASS_READY, COND_NODEPOOL_VALIDATION_SUCCEEDED]
        failed = [a for a in aspects if conds.is_false(a)]
        if failed:
            changed |= conds.set_false(COND_NODEPOOL_READY, failed[0], now=now)
        else:
            changed |= conds.set_true(COND_NODEPOOL_READY, now=now)
        return changed
