"""NodeClaim consistency controller.

Reference: pkg/controllers/nodeclaim/consistency/{controller,nodeshape}.go —
periodically (10m scan period) verifies the invariants between a NodeClaim
and its Node; today the single check is NodeShape: the node's actual capacity
must be >=90% of what the claim was promised per requested resource. Failures
publish an event; a clean scan sets ConsistentStateFound=True.
"""

from __future__ import annotations

from ...apis.nodeclaim import COND_CONSISTENT_STATE_FOUND, COND_INITIALIZED

SCAN_PERIOD_SECONDS = 10 * 60


def node_shape_issues(node, nc) -> list[str]:
    """nodeshape.go:34-60."""
    if nc.metadata.deletion_timestamp is not None or not nc.status.conditions.is_true(COND_INITIALIZED):
        return []
    issues = []
    for name, requested in nc.spec.resources.items():
        expected = nc.status.capacity.get(name)
        actual = node.status.capacity.get(name)
        if not requested or expected is None or not expected:
            continue
        pct = (actual.as_float() if actual is not None else 0.0) / expected.as_float()
        if pct < 0.90:
            issues.append(f"expected {expected} of resource {name}, but found {actual} ({pct * 100:.1f}% of expected)")
    return issues


class ConsistencyController:
    def __init__(self, store, clock, recorder=None):
        self.store = store
        self.clock = clock
        self.recorder = recorder
        self._last_scanned: dict[str, float] = {}  # claim uid -> time

    def reconcile(self) -> None:
        claims = self.store.list("NodeClaim")
        live = {nc.metadata.uid for nc in claims}
        self._last_scanned = {uid: t for uid, t in self._last_scanned.items() if uid in live}
        for nc in claims:
            if not nc.status.provider_id:
                continue
            last = self._last_scanned.get(nc.metadata.uid)
            if last is not None and self.clock.now() - last < SCAN_PERIOD_SECONDS:
                continue
            self._last_scanned[nc.metadata.uid] = self.clock.now()
            node = self.store.try_get("Node", nc.status.node_name) if nc.status.node_name else None
            if node is None:
                continue
            issues = node_shape_issues(node, nc)
            for issue in issues:
                if self.recorder is not None:
                    self.recorder.publish(nc, "FailedConsistencyCheck", issue)
            if not issues and not nc.status.conditions.is_true(COND_CONSISTENT_STATE_FOUND):
                def apply(obj):
                    obj.status.conditions.set_true(COND_CONSISTENT_STATE_FOUND, now=self.clock.now())

                self.store.patch("NodeClaim", nc.metadata.name, apply)
