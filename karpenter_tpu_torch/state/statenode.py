"""StateNode: the in-memory mirror of a (Node, NodeClaim) pair.

Reference: pkg/controllers/state/statenode.go:126-500 — caches capacity,
daemon requests, pod requests, host ports, deletion/nomination flags, and the
disruptability checks used by the disruption controller.
"""

from __future__ import annotations

from typing import Optional

from ..apis import labels as wk
from ..apis.nodeclaim import (
    COND_INITIALIZED,
    COND_REGISTERED,
    NodeClaim,
)
from ..scheduling.hostports import HostPortUsage, pod_host_ports
from ..scheduling.volumeusage import VolumeUsage
from ..scheduling.taints import (
    KNOWN_EPHEMERAL_TAINT_KEY_PREFIXES,
    KNOWN_EPHEMERAL_TAINTS,
    Taint,
    is_known_ephemeral_taint,
)
from ..utils import disruption as disruption_utils
from ..utils import pods as pod_utils
from ..utils import resources as res
from ..utils.quantity import Quantity

NOMINATION_WINDOW_SECONDS = 20.0


class StateNode:
    def __init__(self, node=None, node_claim: Optional[NodeClaim] = None):
        self.node = node
        self.node_claim = node_claim
        self.pod_requests: dict[str, dict[str, Quantity]] = {}
        self.pod_limits: dict[str, dict[str, Quantity]] = {}
        self.pod_disruption_costs: dict[str, float] = {}
        self.daemonset_requests: dict[str, dict[str, Quantity]] = {}
        self.host_port_usage = HostPortUsage()
        self.volume_usage = VolumeUsage()
        self.marked_for_deletion = False
        self.nominated_until = 0.0
        self._total_pod_requests: Optional[dict[str, Quantity]] = None
        self._total_daemon_requests: Optional[dict[str, Quantity]] = None

    # -- identity --------------------------------------------------------------
    def name(self) -> str:
        if self.node is not None:
            return self.node.metadata.name
        return self.node_claim.status.node_name if self.node_claim else ""

    def provider_id(self) -> str:
        if self.node is not None and self.node.spec.provider_id:
            return self.node.spec.provider_id
        return self.node_claim.status.provider_id if self.node_claim else ""

    def hostname(self) -> str:
        return self.labels().get(wk.HOSTNAME_LABEL_KEY, self.name())

    def managed(self) -> bool:
        """Karpenter-managed = has a NodeClaim (statenode.go:459)."""
        return self.node_claim is not None

    def nodepool_name(self) -> Optional[str]:
        return self.labels().get(wk.NODEPOOL_LABEL_KEY)

    # -- merged metadata (nodeclaim wins until node registers; statenode.go:281-339)
    def labels(self) -> dict[str, str]:
        out: dict[str, str] = {}
        if self.node_claim is not None:
            out.update(self.node_claim.metadata.labels)
        if self.node is not None:
            out.update(self.node.metadata.labels)
        return out

    def annotations(self) -> dict[str, str]:
        out: dict[str, str] = {}
        if self.node_claim is not None:
            out.update(self.node_claim.metadata.annotations)
        if self.node is not None:
            out.update(self.node.metadata.annotations)
        return out

    # taints expected to clear during node startup (scheduling/taints.py,
    # mirroring scheduling/taints.go:38-52): kept as class aliases for
    # existing consumers; shared with the initialization gate
    KNOWN_EPHEMERAL_TAINTS = KNOWN_EPHEMERAL_TAINTS
    KNOWN_EPHEMERAL_TAINT_KEY_PREFIXES = KNOWN_EPHEMERAL_TAINT_KEY_PREFIXES

    def taints(self) -> list[Taint]:
        """Node taints, filtering the transient karpenter lifecycle taints that
        scheduling must ignore (statenode.go:311-339): the unregistered/
        disrupted taints always, plus — while a MANAGED node is uninitialized —
        the known ephemeral startup-phase taints and the claim's own
        startupTaints (both are expected to lift before initialization)."""
        source = []
        if self.node is not None and self.registered():
            source = self.node.spec.taints
        elif self.node_claim is not None:
            source = self.node_claim.spec.taints
        elif self.node is not None:
            source = self.node.spec.taints
        ephemeral = {wk.UNREGISTERED_TAINT_KEY, wk.DISRUPTED_TAINT_KEY}
        out = [t for t in source if t.key not in ephemeral]
        if self.node_claim is not None and not self.initialized():
            # MatchTaint semantics: key + effect (the applying agent may set a
            # different value than the claim declared)
            startup = {(t.key, t.effect) for t in self.node_claim.spec.startup_taints}
            out = [
                t
                for t in out
                if not is_known_ephemeral_taint(t) and (t.key, t.effect) not in startup
            ]
        return out

    def registered(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.status.conditions.is_true(COND_REGISTERED)
        return self.node is not None  # unmanaged nodes count as registered

    def initialized(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.status.conditions.is_true(COND_INITIALIZED)
        return self.node is not None

    # -- resources -------------------------------------------------------------
    def capacity(self) -> dict[str, Quantity]:
        """Node capacity plus the synthetic nodes:1 resource used for
        node-count limits. Until the node initializes, zero/absent node
        values are overridden per resource by the claim's — kubelet zeroes
        extended resources at startup (statenode.go:358-375)."""
        base = self._merged_status_vec("capacity")
        return {**base, "nodes": Quantity.parse(1)}

    def allocatable(self) -> dict[str, Quantity]:
        """statenode.go:377-392 Allocatable: same per-resource zero-override
        merge as capacity()."""
        return self._merged_status_vec("allocatable")

    def _merged_status_vec(self, field: str) -> dict[str, Quantity]:
        node_vec = getattr(self.node.status, field) if self.node is not None else None
        claim_vec = getattr(self.node_claim.status, field) if self.node_claim is not None else None
        # a claim whose Node object is gone (terminating window,
        # cluster.delete_node) still reports the claim's numbers regardless
        # of the Initialized condition — the reference's initialized() is
        # false there because it reads a NODE label (statenode.go:349-356)
        if claim_vec is not None and (not self.initialized() or self.node is None):
            if self.node is not None:
                out = dict(node_vec or {})
                for name, q in claim_vec.items():
                    cur = out.get(name)
                    if cur is None or cur.milli == 0:
                        out[name] = q
                return out
            return claim_vec
        return node_vec if node_vec is not None else {}

    def total_pod_requests(self) -> dict[str, Quantity]:
        # memoized AND incrementally maintained: every consolidation
        # simulation rebuilds an ExistingNode from this, and the binder's
        # scheduling pass probes available() between consecutive binds onto
        # the same node — update_for_pod/cleanup_for_pod patch the total in
        # O(resource keys) instead of invalidating it, so a serving-loop
        # bind flush costs O(binds), not O(binds x pods-per-node) re-merges
        if self._total_pod_requests is None:
            self._total_pod_requests = res.merge(*self.pod_requests.values())
        return self._total_pod_requests

    def total_daemon_requests(self) -> dict[str, Quantity]:
        if self._total_daemon_requests is None:
            self._total_daemon_requests = res.merge(*self.daemonset_requests.values())
        return self._total_daemon_requests

    def available(self) -> dict[str, Quantity]:
        """allocatable - all pod requests (statenode.go:395)."""
        return res.subtract(self.allocatable(), self.total_pod_requests())

    def disruption_cost(self) -> float:
        """1.0 per-node base + positive non-daemon pod eviction costs
        (statenode.go:427-434)."""
        return 1.0 + sum(self.pod_disruption_costs.values())

    # -- pod tracking ----------------------------------------------------------
    @staticmethod
    def _patch_total(total: dict | None, old: dict | None, new: dict | None):
        """Apply a (remove old, add new) requests delta to a memoized total.
        Keys reaching zero are dropped — numerically identical to a fresh
        merge everywhere (subtract/fits treat a missing key as 0), though a
        pod carrying an EXPLICIT zero request may leave the fresh merge with
        a zero-valued key this patch has dropped."""
        if total is None:
            return None  # not materialized yet: first read merges fresh
        out = dict(total)
        for k, q in (old or {}).items():
            cur = out.get(k)
            if cur is None:
                continue
            v = cur.milli - q.milli
            if v:
                out[k] = Quantity(v)
            else:
                del out[k]
        for k, q in (new or {}).items():
            cur = out.get(k)
            out[k] = Quantity(cur.milli + q.milli) if cur is not None else q
        return out

    def update_for_pod(self, pod, volumes: dict | None = None) -> None:
        self._total_daemon_requests = None
        key = pod.key()
        requests = res.pod_requests(pod)
        self._total_pod_requests = self._patch_total(self._total_pod_requests, self.pod_requests.get(key), requests)
        self.pod_requests[key] = requests
        self.pod_limits[key] = res.pod_limits(pod)
        # only non-daemon pods with positive eviction cost contribute to the
        # node's disruption cost, matching the Candidate numerator units
        # (statenode.go:477-488)
        if not pod_utils.is_owned_by_daemonset(pod):
            cost = disruption_utils.eviction_cost(pod)
            if cost > 0:
                self.pod_disruption_costs[key] = cost
            else:
                self.pod_disruption_costs.pop(key, None)
        else:
            self.daemonset_requests[key] = requests
        self.host_port_usage.add(key, pod_host_ports(pod))
        if volumes:
            self.volume_usage.add(key, volumes)

    def cleanup_for_pod(self, key: str) -> None:
        self._total_daemon_requests = None
        old = self.pod_requests.get(key)
        if old is not None:
            self._total_pod_requests = self._patch_total(self._total_pod_requests, old, None)
        self.pod_requests.pop(key, None)
        self.pod_limits.pop(key, None)
        self.pod_disruption_costs.pop(key, None)
        self.daemonset_requests.pop(key, None)
        self.host_port_usage.remove(key)
        self.volume_usage.remove(key)

    # -- disruption flags ------------------------------------------------------
    def nominate(self, now: float) -> None:
        self.nominated_until = now + NOMINATION_WINDOW_SECONDS

    def nominated(self, now: float) -> bool:
        return self.nominated_until > now

    def deleted(self) -> bool:
        return (self.node is not None and self.node.metadata.deletion_timestamp is not None) or (
            self.node_claim is not None and self.node_claim.metadata.deletion_timestamp is not None
        )

    def validate_node_disruptable(self, now: float) -> str | None:
        """Gate for disruption candidacy (statenode.go:212-242)."""
        if self.node_claim is None or self.node is None:
            return "node is not managed or not yet paired"
        if not self.initialized():
            return "node is not initialized"
        if self.marked_for_deletion or self.deleted():
            return "node is deleting or marked for deletion"
        if self.nominated(now):
            return "node is nominated for pending pods"
        if self.annotations().get(wk.DO_NOT_DISRUPT_ANNOTATION_KEY) == "true":
            return "disruption is blocked through the do-not-disrupt annotation"
        if self.nodepool_name() is None:
            return "node does not have the nodepool label"
        return None

    def shallow_copy(self) -> "StateNode":
        c = StateNode(self.node, self.node_claim)
        c.pod_requests = dict(self.pod_requests)
        c.pod_limits = dict(self.pod_limits)
        c.pod_disruption_costs = dict(self.pod_disruption_costs)
        c.daemonset_requests = dict(self.daemonset_requests)
        c.host_port_usage = self.host_port_usage.copy()
        c.volume_usage = self.volume_usage.copy()
        c.marked_for_deletion = self.marked_for_deletion
        c.nominated_until = self.nominated_until
        # carry the memoized totals, materializing them on the LIVE node
        # first (copies are handed out per availability probe via
        # cluster.node_for_name and then discarded — a memo computed only on
        # the copy would never stick, and re-merging every pod on the node
        # per probe dominated the binder's scheduling pass under churn).
        # Safe to share: _patch_total is copy-on-write, total_pod_requests
        # returns the same dict a fresh merge would
        c._total_pod_requests = self.total_pod_requests()
        c._total_daemon_requests = self.total_daemon_requests()
        return c
