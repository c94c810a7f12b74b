"""Static scale-down: delete surplus NodeClaims when replicas shrink.

Reference: static/deprovisioning/controller.go:84-135 + candidate selection
:185-313 — surplus = live claims minus spec.replicas; candidates are picked
cheapest-to-disrupt first: unlaunched claims (no providerID), then empty
nodes, then lowest rescheduling-cost x lifetime-remaining, with
do-not-disrupt-hosting nodes last.
"""

from __future__ import annotations

from ...apis import labels as wk
from ...utils import disruption as disruption_utils
from ...utils import pods as pod_utils

TERMINATION_REASON = "overprovisioned"


class StaticDeprovisioningController:
    def __init__(self, store, cluster, cloud_provider, clock, recorder=None, metrics=None):
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        self.metrics = metrics

    def reconcile(self) -> None:
        for np in self.store.list("NodePool"):
            if not np.is_static() or np.metadata.deletion_timestamp is not None:
                continue
            self._reconcile_pool(np)

    def _reconcile_pool(self, np) -> None:
        from ...apis.nodeclaim import COND_DISRUPTION_REASON

        pool = np.metadata.name
        # claims already pending disruption don't count as running: the
        # disruption queue is mid-replacement and the fleet would otherwise
        # look transiently over-provisioned (deprovisioning controller.go:95-99)
        live = [
            nc
            for nc in self.store.list("NodeClaim")
            if nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY) == pool
            and nc.metadata.deletion_timestamp is None
            and not nc.status.conditions.is_true(COND_DISRUPTION_REASON)
        ]
        surplus = len(live) - (np.spec.replicas or 0)
        if surplus <= 0:
            return
        for nc in self._candidates(np, live, surplus):
            self.store.try_delete("NodeClaim", nc.metadata.name)
            self.cluster.mark_for_deletion([nc.status.provider_id or f"nodeclaim://{nc.metadata.name}"])
            if self.recorder is not None:
                self.recorder.publish(nc, "Deprovisioned", f"static nodepool {pool} {TERMINATION_REASON}")
            if self.metrics is not None:
                from ... import metrics as m

                self.metrics.counter(m.NODECLAIMS_TERMINATED_TOTAL).inc(
                    nodepool=pool,
                    capacity_type=nc.metadata.labels.get(wk.CAPACITY_TYPE_LABEL_KEY, ""),
                    zone=nc.metadata.labels.get(wk.ZONE_LABEL_KEY, ""),
                )

    def _candidates(self, np, live: list, count: int) -> list:
        """Selection priority (deprovisioning/controller.go:181-313)."""
        # 1. claims that never launched (no providerID)
        unresolved = [nc for nc in live if not nc.status.provider_id]
        picked = unresolved[:count]
        if len(picked) == count:
            return picked

        resolved = [nc for nc in live if nc.status.provider_id]
        empties, nonempty = [], []
        for nc in resolved:
            sn = self.cluster.node_for_claim(nc.metadata.name)
            if sn is None or sn.marked_for_deletion:
                continue
            pods = self._pods_on(sn.name())
            dnd = any(pod_utils.has_do_not_disrupt(p, self.clock.now()) for p in pods)
            non_daemon = [p for p in pods if not pod_utils.is_owned_by_daemonset(p)]
            if not non_daemon and not dnd:
                empties.append(nc)
            else:
                nonempty.append((nc, pods, dnd))

        # 2. empty nodes
        picked += empties[: count - len(picked)]
        if len(picked) == count:
            return picked

        # 3. cheapest-to-disrupt: rescheduling cost x lifetime remaining;
        #    do-not-disrupt hosts sort last regardless of cost
        from ...utils.durations import parse_duration

        expire_after = parse_duration(np.spec.template.expire_after)
        nonempty.sort(
            key=lambda t: (
                t[2],
                disruption_utils.rescheduling_cost(t[1])
                * disruption_utils.lifetime_remaining(self.clock.now(), expire_after, t[0].metadata.creation_timestamp),
            )
        )
        picked += [nc for nc, _, _ in nonempty[: count - len(picked)]]
        return picked

    def _pods_on(self, node_name: str) -> list:
        return [
            p
            for p in self.store.list("Pod")
            if p.spec.node_name == node_name and pod_utils.is_active(p)
        ]
