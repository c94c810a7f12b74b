"""NodePool registration-health controller.

Reference: pkg/controllers/nodepool/registrationhealth/controller.go:66-111 —
hydrates the in-memory health tracker from a persisted condition after a
restart, and resets NodeRegistrationHealthy to Unknown whenever the NodePool
spec (generation) or its NodeClass generation changes. The lifecycle
registration/liveness reconcilers feed successes/failures into the tracker.
"""

from __future__ import annotations

from ...apis.conditions import UNKNOWN
from ...apis.nodepool import COND_NODE_REGISTRATION_HEALTHY
from ...state import nodepoolhealth


class NodePoolRegistrationHealthController:
    def __init__(self, store, np_state: nodepoolhealth.NodePoolHealthState, clock):
        self.store = store
        self.np_state = np_state
        self.clock = clock
        # pool uid -> (pool generation, node class generation) last observed
        self._observed: dict[str, tuple[int, int]] = {}

    def reconcile(self) -> None:
        pools = self.store.list("NodePool")
        live = {np.metadata.uid for np in pools}
        self.np_state.prune(live)
        self._observed = {uid: v for uid, v in self._observed.items() if uid in live}
        for np in pools:
            ref = np.spec.template.node_class_ref
            kind = ref["kind"] if isinstance(ref, dict) else ref.kind
            name = ref["name"] if isinstance(ref, dict) else ref.name
            node_class = self.store.try_get(kind, name)
            if node_class is None:
                continue
            uid = np.metadata.uid
            cond = np.status.conditions.get(COND_NODE_REGISTRATION_HEALTHY)

            # restart hydration: persisted condition pre-populates the tracker
            if self.np_state.status(uid) == nodepoolhealth.STATUS_UNKNOWN and cond is not None:
                if np.status.conditions.is_true(COND_NODE_REGISTRATION_HEALTHY):
                    self.np_state.set_status(uid, nodepoolhealth.STATUS_HEALTHY)
                elif np.status.conditions.is_false(COND_NODE_REGISTRATION_HEALTHY):
                    self.np_state.set_status(uid, nodepoolhealth.STATUS_UNHEALTHY)

            observed = (np.metadata.generation, node_class.metadata.generation)
            if cond is None or self._observed.get(uid) not in (None, observed):
                def apply(obj):
                    obj.status.conditions.set(COND_NODE_REGISTRATION_HEALTHY, UNKNOWN, now=self.clock.now())

                self.store.patch("NodePool", np.metadata.name, apply)
                self.np_state.set_status(uid, nodepoolhealth.STATUS_UNKNOWN)
            self._observed[uid] = observed
