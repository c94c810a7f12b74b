"""NodeClaim pod-events controller.

Reference: pkg/controllers/nodeclaim/podevents/controller.go — when a pod is
newly bound, turns terminal, or starts terminating on a karpenter node, stamp
NodeClaim.status.lastPodEventTime (deduped to one write per dedupeTimeout).
Consolidation's consolidateAfter clock keys off this timestamp.
"""

from __future__ import annotations

from ...utils import pods as pod_utils

DEDUPE_TIMEOUT_SECONDS = 10.0


class PodEventsController:
    """Watch-driven: register() subscribes to the store's Pod watch feed."""

    def __init__(self, store, clock):
        self.store = store
        self.clock = clock
        # pod key -> (node_name, terminal, terminating) last observed
        self._observed: dict[str, tuple[str, bool, bool]] = {}

    def register(self) -> None:
        self.store.watch("Pod", self._on_pod_event)

    def _on_pod_event(self, event: str, pod) -> None:
        key = pod.key()
        prev = self._observed.get(key, ("", False, False))
        terminal = pod.status.phase in ("Succeeded", "Failed")
        terminating = pod.metadata.deletion_timestamp is not None
        if pod_utils.is_owned_by_daemonset(pod):
            return
        if event == "DELETED":
            # a finalizer-less delete emits only DELETED; the node the pod
            # leaves still needs its consolidateAfter idle clock reset
            self._observed.pop(key, None)
            if prev[0]:
                self._stamp(prev[0])
            return
        self._observed[key] = (pod.spec.node_name, terminal, terminating)
        bound = prev[0] == "" and pod.spec.node_name != ""
        unbound = prev[0] != "" and pod.spec.node_name == ""  # eviction unbind
        went_terminal = not prev[1] and terminal
        went_terminating = not prev[2] and terminating
        if unbound:
            self._stamp(prev[0])
            return
        if not pod.spec.node_name:
            return
        if not (bound or went_terminal or went_terminating):
            return
        self._stamp(pod.spec.node_name)

    def _stamp(self, node_name: str) -> None:
        node = self.store.borrow_get("Node", node_name)
        if node is None:
            return
        provider_id = node.spec.provider_id
        nc = next(
            (c for c in self.store.borrow_list("NodeClaim") if c.status.node_name == node_name or c.status.provider_id == provider_id),
            None,
        )
        if nc is None:
            return
        if nc.status.last_pod_event_time and self.clock.now() - nc.status.last_pod_event_time < DEDUPE_TIMEOUT_SECONDS:
            return

        def apply(obj):
            obj.status.last_pod_event_time = self.clock.now()

        self.store.patch("NodeClaim", nc.metadata.name, apply)
