"""NodeClaim disruption-readiness controller: sets the Consolidatable and
Drifted status conditions (reference: nodeclaim/disruption/{consolidation.go:40,
drift.go:51-86}).
"""

from __future__ import annotations

import math

from ...apis import labels as wk
from ...apis.nodeclaim import COND_CONSOLIDATABLE, COND_DRIFTED, COND_INITIALIZED
from ...kube.store import Conflict, NotFound
from ...scheduling.requirements import Requirements


class NodeClaimDisruptionController:
    def __init__(self, store, cluster, cloud_provider, clock):
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self._it_index_by_pool: dict[str, dict] = {}

    def reconcile(self) -> None:
        pools = {np.metadata.name: np for np in self.store.list("NodePool")}
        self._it_index_by_pool = {}  # per-reconcile: pool -> {it.name: it}
        for nc in self.store.list("NodeClaim"):
            if nc.metadata.deletion_timestamp is not None:
                continue
            pool = pools.get(nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""))
            if pool is None:
                continue
            changed = self._consolidatable(nc, pool)
            changed |= self._drifted(nc, pool)
            if changed:
                try:
                    self.store.update(nc)
                    self.cluster.update_node_claim(nc)
                except (Conflict, NotFound):
                    # a concurrent writer won (or the claim vanished): the
                    # next reconcile recomputes the conditions from fresh
                    # state — only the EXPECTED optimistic-concurrency
                    # failures are absorbed, anything else propagates
                    pass

    def _consolidatable(self, nc, pool) -> bool:
        """Consolidatable flips true once consolidateAfter has elapsed since
        the last pod event (or initialization)."""
        if not nc.status.conditions.is_true(COND_INITIALIZED):
            return nc.status.conditions.clear(COND_CONSOLIDATABLE)
        ca = pool.spec.disruption.consolidate_after_seconds()
        if ca == math.inf:  # Never
            return nc.status.conditions.clear(COND_CONSOLIDATABLE)
        init = nc.status.conditions.get(COND_INITIALIZED)
        base = nc.status.last_pod_event_time or init.last_transition_time
        if self.clock.now() - base >= ca:
            return nc.status.conditions.set_true(COND_CONSOLIDATABLE, now=self.clock.now())
        return nc.status.conditions.set_false(
            COND_CONSOLIDATABLE, "NotConsolidatable", now=self.clock.now()
        )

    # the reference postpones instance-type staleness checks until an hour
    # after claim creation (drift.go:93-96)
    INSTANCE_TYPE_DRIFT_DELAY_SECONDS = 3600.0

    def _drifted(self, nc, pool) -> bool:
        """Drift detection in the reference's precedence (drift.go:86-113):
        nodepool static-hash drift, then requirement drift, then stale
        instance-type drift (delayed 1h from creation), then cloud-provider
        drift last. An unlaunched claim CLEARS the condition (drift.go:57-62)."""
        if not nc.is_launched():
            return nc.status.conditions.clear(COND_DRIFTED)
        reason = ""
        if self._static_drift(nc, pool):
            reason = "NodePoolDrifted"
        elif self._requirement_drift(nc, pool):
            reason = "RequirementsDrifted"
        elif self._instance_type_not_found(nc, pool):
            reason = "InstanceTypeNotFound"
        else:
            reason = self.cloud_provider.is_drifted(nc) or ""
        if reason:
            return nc.status.conditions.set_true(COND_DRIFTED, reason=reason, now=self.clock.now())
        return nc.status.conditions.clear(COND_DRIFTED)

    def _instance_type_not_found(self, nc, pool) -> bool:
        """Stale instance-type drift (drift.go:116-149): the claim's instance
        type vanished from the provider, or no longer has an offering
        compatible with the claim's labels. Reserved claims may be demoted to
        on-demand post-creation, so both capacity types pass."""
        created = nc.metadata.creation_timestamp or 0.0
        if self.clock.now() - created < self.INSTANCE_TYPE_DRIFT_DELAY_SECONDS:
            return False
        it_name = nc.metadata.labels.get(wk.INSTANCE_TYPE_LABEL_KEY)
        if not it_name:
            return True
        index = self._it_index_by_pool.get(pool.metadata.name)
        if index is None:
            index = {x.name: x for x in self.cloud_provider.get_instance_types(pool)}
            self._it_index_by_pool[pool.metadata.name] = index
        it = index.get(it_name)
        if it is None:
            return True
        from ...scheduling.requirements import Requirement

        reqs = Requirements.from_labels(nc.metadata.labels)
        if nc.metadata.labels.get(wk.CAPACITY_TYPE_LABEL_KEY) == wk.CAPACITY_TYPE_RESERVED:
            reqs.replace(
                Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [wk.CAPACITY_TYPE_RESERVED, wk.CAPACITY_TYPE_ON_DEMAND])
            )
            reqs.remove(wk.RESERVATION_ID_LABEL_KEY)
        return not any(reqs.compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) is None for o in it.offerings)

    @staticmethod
    def _static_drift(nc, pool) -> bool:
        """Hash drift gated on matching hash VERSIONS on both sides
        (drift.go:154-168)."""
        pool_hash = pool.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY)
        pool_ver = pool.metadata.annotations.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY)
        claim_hash = nc.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY)
        claim_ver = nc.metadata.annotations.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY)
        # all four annotations must exist and the versions must match before
        # hashes are comparable — cross-version hashes are never compared
        if pool_hash is None or pool_ver is None or claim_hash is None or claim_ver is None:
            return False
        if pool_ver != claim_ver:
            return False
        return claim_hash != pool_hash

    @staticmethod
    def _requirement_drift(nc, pool) -> bool:
        """compatible(), not intersects(): a NodePool requirement on a key the
        claim lacks entirely must flag drift (drift.go:175)."""
        pool_reqs = Requirements.from_node_selector_terms(pool.spec.template.requirements)
        pool_reqs.add(*Requirements.from_labels(pool.spec.template.labels).values())
        claim_labels = Requirements.from_labels(nc.metadata.labels)
        return claim_labels.compatible(pool_reqs) is not None
