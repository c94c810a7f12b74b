"""Cluster: the in-memory mirror of nodes/nodeclaims/pods/bindings.

Reference: pkg/controllers/state/cluster.go:54-126 — fed by informer watch
events, gates the provisioning and disruption loops via synced(), tracks
pod-ack times, the per-pool consolidated state, and anti-affinity pods.

This layer is also where the TPU solver's incremental tensor cache hooks in:
every mutation bumps a generation counter so the encoder can avoid re-uploading
unchanged snapshots (SURVEY.md §7 stage 3).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

from ..apis import labels as wk
from ..obs.racecheck import make_rlock
from ..apis.nodeclaim import NodeClaim
from ..scheduling.volumeusage import get_volumes
from ..utils import pods as pod_utils
from ..utils import resources as res
from ..utils.quantity import Quantity
from .statenode import StateNode

_EPOCH_COUNTER = itertools.count(1)


class Cluster:
    # racecheck guarded-field registry (analysis: guarded-field-access).
    # Sanctioned order: `_lock` may acquire the store's lock (borrowed
    # reads) and the clock's, never the reverse — see the serving-stack
    # lock inventory in karpenter_tpu/serving/__init__.py.
    GUARDED_FIELDS = {
        "_nodes": "_lock",
        "_node_name_to_provider_id": "_lock",
        "_nodeclaim_name_to_provider_id": "_lock",
        "_bindings": "_lock",
        "_anti_affinity_pods": "_lock",
        "_pod_acks": "_lock",
        "_pod_rvs": "_lock",
        "_consolidated_at": "_lock",
        "_buffer_pod_counts": "_lock",
    }

    def __init__(self, store, clock):
        self.store = store
        self.clock = clock
        self._lock = make_rlock("cluster")
        self._nodes: dict[str, StateNode] = {}  # provider-id (or node name) -> StateNode
        self._node_name_to_provider_id: dict[str, str] = {}
        self._nodeclaim_name_to_provider_id: dict[str, str] = {}
        self._bindings: dict[str, str] = {}  # pod key -> node name
        self._anti_affinity_pods: set[str] = set()  # pod keys with required anti-affinity
        self._pod_acks: dict[str, float] = {}  # pod key -> first-seen-pending time
        # pod key -> last resourceVersion applied via update_pod. The
        # watch-loss resync (faultline) diffs this against store content to
        # find exactly the pods whose events a lossy stream lost — untouched
        # pods are never re-applied, so a resync with no drift mutates
        # nothing (no generation bump, delta caches intact).
        self._pod_rvs: dict[str, int] = {}
        self._pod_scheduling_decisions: dict[str, float] = {}
        self._pod_to_node_claim: dict[str, str] = {}
        self._consolidated_at: float = 0.0
        self._buffer_pod_counts: dict[str, int] = {}  # provider id -> virtual pod count
        self._unsynced_start: Optional[float] = None
        self.generation = 0  # bumped on every mutation (consolidation freshness)
        # bumped only by mutations that change what the solver's ROW side can
        # observe (nodes/claims/bindings/usage/anti-affinity membership) — the
        # encode row-cache key. A pending-pod arrival or edit bumps only
        # `generation`: under steady-state churn that is the dominant event,
        # and keying the row cache on it would forbid the encoder's pod-delta
        # path from ever serving a live provisioner.
        self.node_generation = 0
        # process-unique token for cache keys: id() can recycle after GC
        self.epoch = next(_EPOCH_COUNTER)
        self._on_change: list[Callable[[], None]] = []

    # -- change hooks ----------------------------------------------------------
    def on_change(self, fn: Callable[[], None]) -> None:
        self._on_change.append(fn)

    def _bump(self, rows: bool = True) -> None:
        """`rows=False` is the narrow carve-out for pod events that provably
        touch no row-side state (a pending pod's ack): everything else —
        including every pre-existing call site — advances both counters."""
        self.generation += 1
        if rows:
            self.node_generation += 1
        self.mark_unconsolidated()
        for fn in self._on_change:
            fn()

    # -- synced gate (cluster.go:128-168) -------------------------------------
    def synced(self) -> bool:
        """True when every NodeClaim with a provider id has a StateNode and all
        store nodes are mirrored. With the in-process store we are effectively
        always synced once informers ran; the check still guards tests that
        bypass informers."""
        with self._lock:
            claim_ids = {
                nc.status.provider_id
                for nc in self.store.borrow_list("NodeClaim")
                if nc.status.provider_id and nc.metadata.deletion_timestamp is None
            }
            node_ids = {n.spec.provider_id for n in self.store.borrow_list("Node") if n.spec.provider_id}
            known = set(self._nodes.keys())
            return claim_ids.issubset(known) and node_ids.issubset(known)

    # -- accessors -------------------------------------------------------------
    def nodes(self) -> list[StateNode]:
        with self._lock:
            return [n.shallow_copy() for n in self._nodes.values()]

    def nodes_view(self) -> list[StateNode]:
        """Borrowed views of the live StateNodes (read-only contract, like
        Store.borrow_list). The consolidation loop builds one scheduling
        simulation per candidate; shallow-copying every StateNode per
        simulation dominated at reference scale. The scheduler and candidate
        builders only read (ExistingNode copies usage/derived state into its
        own fields before mutating)."""
        with self._lock:
            return list(self._nodes.values())

    def node_for_name(self, name: str) -> Optional[StateNode]:
        with self._lock:
            pid = self._node_name_to_provider_id.get(name)
            n = self._nodes.get(pid) if pid else None
            return n.shallow_copy() if n else None

    def node_for_claim(self, claim_name: str) -> Optional[StateNode]:
        with self._lock:
            pid = self._nodeclaim_name_to_provider_id.get(claim_name)
            n = self._nodes.get(pid) if pid else None
            return n.shallow_copy() if n else None

    def bindings(self) -> dict[str, str]:
        with self._lock:
            return dict(self._bindings)

    def nodepool_resources(self, nodepool_name: str) -> dict[str, Quantity]:
        """Total launched resources per pool (for limits enforcement)."""
        with self._lock:
            totals: list[dict[str, Quantity]] = []
            for n in self._nodes.values():
                if n.labels().get(wk.NODEPOOL_LABEL_KEY) == nodepool_name and not n.deleted():
                    totals.append(n.capacity())
            return res.merge(*totals)

    def nodepool_node_count(self, nodepool_name: str) -> int:
        with self._lock:
            return sum(
                1
                for n in self._nodes.values()
                if n.labels().get(wk.NODEPOOL_LABEL_KEY) == nodepool_name and not n.deleted()
            )

    # -- consolidation timestamp (cluster.go:583-607) --------------------------
    def consolidated(self) -> bool:
        with self._lock:
            return self._consolidated_at > 0 and (self.clock.now() - self._consolidated_at) < 300.0

    def mark_consolidated(self) -> None:
        with self._lock:
            self._consolidated_at = self.clock.now()

    def mark_unconsolidated(self) -> None:
        # also called directly as a store watch callback (informer
        # NodePool/DaemonSet subscriptions) on the delivery thread — the
        # write needs the lock there; reentrant under _bump's callers
        with self._lock:
            self._consolidated_at = 0.0

    # -- updates (driven by informers; cluster.go:360-442) ---------------------
    def update_node(self, node) -> None:
        with self._lock:
            pid = node.spec.provider_id or node.metadata.name
            old_pid = self._node_name_to_provider_id.get(node.metadata.name)
            if old_pid is not None and old_pid != pid:
                # node gained its provider id: migrate the name-keyed StateNode
                # so it is never double-counted (cluster.go:399-405 refuses to
                # track managed nodes until providerID is set)
                stale = self._nodes.pop(old_pid, None)
                if stale is not None and pid not in self._nodes:
                    self._nodes[pid] = stale
            existing = self._nodes.get(pid)
            if existing is None:
                self._nodes[pid] = StateNode(node=node)
            else:
                existing.node = node
            self._node_name_to_provider_id[node.metadata.name] = pid
            # per-driver volume limits from the node's CSINode (cluster.go:854)
            csi = self.store.try_get("CSINode", node.metadata.name)
            if csi is not None:
                self._apply_csi_limits(self._nodes[pid], csi)
            # re-pair claim if one exists with this provider id
            for claim_name, claim_pid in list(self._nodeclaim_name_to_provider_id.items()):
                if claim_pid == pid and self._nodes[pid].node_claim is None:
                    nc = self.store.try_get("NodeClaim", claim_name)
                    if nc is not None:
                        self._nodes[pid].node_claim = nc
            self._rebind_pods_for_node(node.metadata.name)
            self._bump()

    def delete_node(self, name: str) -> None:
        with self._lock:
            pid = self._node_name_to_provider_id.pop(name, None)
            if pid is None:
                return
            sn = self._nodes.get(pid)
            if sn is not None:
                if sn.node_claim is not None:
                    sn.node = None  # claim still owns the slot
                else:
                    del self._nodes[pid]
            self._bump()

    def update_node_claim(self, nc: NodeClaim) -> None:
        # private copy before retaining: watch events now deliver ONE clone
        # shared by every watcher under a read-only contract (store._drain),
        # and the cluster MUTATES its retained claim in place
        # (_record_pod_event_on_claim stamps last_pod_event_time)
        from ..kube.clone import fast_deepcopy

        nc = fast_deepcopy(nc)
        with self._lock:
            # claims are tracked from creation (pre-launch) under a synthetic
            # key so back-to-back solves see in-flight capacity; the entry is
            # migrated once the provider id appears
            pid = nc.status.provider_id or f"nodeclaim://{nc.metadata.name}"
            old_pid = self._nodeclaim_name_to_provider_id.get(nc.metadata.name)
            if old_pid is not None and old_pid != pid:
                # claim gained its provider id: migrate the StateNode so
                # nomination and usage tracking survive the key change
                stale = self._nodes.pop(old_pid, None)
                if stale is not None and pid not in self._nodes:
                    self._nodes[pid] = stale
            self._nodeclaim_name_to_provider_id[nc.metadata.name] = pid
            existing = self._nodes.get(pid)
            if existing is None:
                self._nodes[pid] = StateNode(node_claim=nc)
            else:
                existing.node_claim = nc
            if nc.metadata.deletion_timestamp is not None:
                self._nodes[pid].marked_for_deletion = True
            self._bump()

    def delete_node_claim(self, name: str) -> None:
        with self._lock:
            pid = self._nodeclaim_name_to_provider_id.pop(name, None)
            if pid is None:
                return
            sn = self._nodes.get(pid)
            if sn is not None:
                if sn.node is not None:
                    sn.node_claim = None
                else:
                    del self._nodes[pid]
            self._bump()

    def update_buffer_pod_counts(self, counts: dict[str, int]) -> None:
        """Replace the whole mapping each provisioning pass; nodes absent from
        it host no buffer capacity (cluster.go:299-315). Emptiness consults it;
        consolidation doesn't need to — its simulation re-places virtual pods."""
        with self._lock:
            self._buffer_pod_counts = dict(counts)

    def has_buffer_pods(self, provider_id: str) -> bool:
        with self._lock:
            return self._buffer_pod_counts.get(provider_id, 0) > 0

    def apply_csi_node(self, csi) -> None:
        """CSINode events arrive after node registration in practice; refresh
        the paired StateNode's per-driver limits whenever one lands."""
        with self._lock:
            sn = self._state_node_for(csi.metadata.name)
            if sn is not None:
                self._apply_csi_limits(sn, csi)
                self._bump()

    @staticmethod
    def _apply_csi_limits(sn: StateNode, csi) -> None:
        for driver in csi.drivers:
            if driver.allocatable_count is not None:
                sn.volume_usage.add_limit(driver.name, driver.allocatable_count)

    def update_pod(self, pod) -> None:
        with self._lock:
            key = pod.key()
            self._pod_rvs[key] = pod.metadata.resource_version
            terminating = pod.metadata.deletion_timestamp is not None
            # row impact: released/recorded usage or bindings, or a change of
            # anti-affinity membership (the encoder's inverse-anti entries
            # read it). A pending pod's create/edit touches neither.
            rows = False
            if pod_utils.is_terminal(pod):
                rows = key in self._bindings
                # only TERMINAL pods release usage (cluster.go:433-436): a
                # terminating pod still occupies its node until it is gone
                # (delete_pod handles that), and candidates must keep seeing
                # it — e.g. terminating StatefulSet pods reserve capacity
                bound_node = self._bindings.get(key)
                self._remove_pod_usage(key)
                if bound_node is not None and not pod_utils.is_owned_by_daemonset(pod):
                    self._record_pod_event_on_claim(bound_node)
            elif pod.spec.node_name:
                # bound pods — terminating ones included, so a pod first
                # observed mid-termination (informer replay after restart)
                # still records its binding and usage
                rows = True
                old_node = self._bindings.get(key)
                newly_bound = old_node != pod.spec.node_name
                if old_node is not None and newly_bound:
                    self._remove_pod_usage(key)
                self._bindings[key] = pod.spec.node_name
                sn = self._state_node_for(pod.spec.node_name)
                if sn is not None:
                    sn.update_for_pod(pod, volumes=get_volumes(self.store, pod))
                self._pod_acks.pop(key, None)
                # lastPodEventTime: genuine bind transitions and termination
                # starts, never for DaemonSet pods, deduped at 10s
                # (podevents/controller.go:110-121)
                if (newly_bound or terminating) and not pod_utils.is_owned_by_daemonset(pod):
                    self._record_pod_event_on_claim(pod.spec.node_name)
            elif not terminating:
                self._pod_acks.setdefault(key, self.clock.now())
            if _has_required_anti_affinity(pod):
                before = key in self._anti_affinity_pods
                if pod_utils.is_active(pod):
                    self._anti_affinity_pods.add(key)
                else:
                    self._anti_affinity_pods.discard(key)
                rows = rows or (key in self._anti_affinity_pods) != before
            self._bump(rows=rows)

    def delete_pod(self, key: str) -> None:
        with self._lock:
            rows = key in self._bindings or key in self._anti_affinity_pods
            self._remove_pod_usage(key)
            self._anti_affinity_pods.discard(key)
            self._pod_acks.pop(key, None)
            self._pod_rvs.pop(key, None)
            self._bump(rows=rows)

    def resync_pods(self) -> tuple[int, int]:
        """Level-triggered convergence after watch loss: re-derive the pod
        mirror from store CONTENT (the authority) instead of the delivered
        event stream. Only pods whose resourceVersion differs from the last
        one applied are re-played through update_pod, and mirrored pods the
        store no longer holds are deleted — so when nothing was actually
        lost this is a pure read (zero mutations, placements untouched).
        Returns (stale_updated, gone_deleted)."""
        from ..kube.clone import fast_deepcopy

        with self._lock:
            known = dict(self._pod_rvs)
        stale, seen = [], set()
        for pod in self.store.borrow_list("Pod"):
            key = pod.key()
            seen.add(key)
            if known.get(key) != pod.metadata.resource_version:
                # clone before applying: update_pod may retain the object
                # (StateNode pod usage), and borrowed store objects must
                # never escape the borrow contract
                stale.append(fast_deepcopy(pod))
        gone = [key for key in known if key not in seen]
        for pod in stale:
            self.update_pod(pod)
        for key in gone:
            self.delete_pod(key)
        return len(stale), len(gone)

    # -- helpers ---------------------------------------------------------------
    def _state_node_for(self, node_name: str) -> Optional[StateNode]:  # solverlint: ok(guarded-field-access): caller-holds contract — every call site sits inside `with self._lock`
        pid = self._node_name_to_provider_id.get(node_name)
        return self._nodes.get(pid) if pid else None

    def _remove_pod_usage(self, key: str) -> None:  # solverlint: ok(guarded-field-access): caller-holds contract — invoked only from update_pod/delete_pod under `with self._lock`
        node_name = self._bindings.pop(key, None)
        if node_name is not None:
            sn = self._state_node_for(node_name)
            if sn is not None:
                sn.cleanup_for_pod(key)

    def _rebind_pods_for_node(self, node_name: str) -> None:  # solverlint: ok(guarded-field-access): caller-holds contract — invoked only from update_node under `with self._lock`
        """When a node (re)appears, replay bound pods onto its StateNode."""
        sn = self._state_node_for(node_name)
        if sn is None:
            return
        # borrowed scan: update_for_pod derives requests/ports and retains
        # nothing from the pod object
        for pod in self.store.borrow_list("Pod"):
            # terminating (non-terminal) pods still occupy the node — same
            # rule as update_pod (cluster.go:433-436)
            if pod.spec.node_name == node_name and not pod_utils.is_terminal(pod):
                self._bindings[pod.key()] = node_name
                sn.update_for_pod(pod, volumes=get_volumes(self.store, pod))

    def _record_pod_event_on_claim(self, node_name: str) -> None:
        sn = self._state_node_for(node_name)
        if sn is not None and sn.node_claim is not None:
            now = self.clock.now()
            if now - sn.node_claim.status.last_pod_event_time >= 10.0:  # dedupe window
                sn.node_claim.status.last_pod_event_time = now

    def pods_with_anti_affinity(self) -> list:
        """Borrowed views — consumers (inverse-affinity counting) only read."""
        with self._lock:
            out = []
            for key in self._anti_affinity_pods:
                ns, name = key.split("/", 1)
                pod = self.store.borrow_get("Pod", name, ns)
                if pod is not None:
                    out.append(pod)
            return out

    def ack_pods(self, keys: list[str]) -> None:
        pass  # scheduling-latency metrics hook; recorded via _pod_acks

    def mark_for_deletion(self, provider_ids: list[str]) -> None:
        with self._lock:
            for pid in provider_ids:
                if pid in self._nodes:
                    self._nodes[pid].marked_for_deletion = True
            self._bump()

    def unmark_for_deletion(self, provider_ids: list[str]) -> None:
        with self._lock:
            for pid in provider_ids:
                if pid in self._nodes:
                    self._nodes[pid].marked_for_deletion = False
            self._bump()

    def nominate_node(self, node_name: str) -> None:
        with self._lock:
            sn = self._state_node_for(node_name)
            if sn is not None:
                sn.nominate(self.clock.now())

    def nominate_claim(self, claim_name: str) -> None:
        """Nominate an in-flight NodeClaim's StateNode so disruption leaves
        the just-provisioned capacity alone until its pods land (the
        reference's RecordPodNomination on CreateNodeClaims)."""
        with self._lock:
            pid = self._nodeclaim_name_to_provider_id.get(claim_name)
            sn = self._nodes.get(pid) if pid else None
            if sn is not None:
                sn.nominate(self.clock.now())


def _has_required_anti_affinity(pod) -> bool:
    aff = pod.spec.affinity
    return aff is not None and bool(aff.pod_anti_affinity_required)
