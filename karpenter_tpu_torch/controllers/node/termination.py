"""Node termination: finalizer-driven drain (reference:
node/termination/{controller,terminator}.go — call stack SURVEY.md §3.4).

Flow: node deleted (disruption queue or user) -> taint disrupted ->
evict pods in priority groups (PDB-aware) -> cloud instance deleted ->
finalizer released.

Eviction in this hermetic substrate models controller-recreated workloads:
an evicted pod is reset to Pending/unbound (as a ReplicaSet would recreate
it), which feeds straight back into the provisioner's pending-pod batch.
DaemonSet- and node-owned pods are deleted with their node.
"""

from __future__ import annotations

from ...apis import labels as wk
from ...cloudprovider.errors import NodeClaimNotFoundError
from ...scheduling.taints import NO_SCHEDULE, Taint, taints_tolerate_pod
from ...utils import pods as pod_utils
from ...utils.pdb import PDBLimits

DISRUPTED_TAINT = Taint(key=wk.DISRUPTED_TAINT_KEY, effect=NO_SCHEDULE)
# well-known k8s label: service controllers drop labeled nodes from external
# load-balancer target groups (corev1.LabelNodeExcludeBalancers)
EXCLUDE_BALANCERS_LABEL_KEY = "node.kubernetes.io/exclude-from-external-load-balancers"


class TerminationController:
    def __init__(self, store, cluster, cloud_provider, clock, recorder=None, metrics=None):
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        self.metrics = metrics

    def reconcile(self) -> None:
        for node in self.store.list("Node"):
            if node.metadata.deletion_timestamp is None:
                continue
            if wk.TERMINATION_FINALIZER not in node.metadata.finalizers:
                continue
            # per-item error isolation (controller-runtime semantics): a
            # transient cloud delete failure keeps the finalizer and retries
            # next round; it never kills the rest of the drain fleet
            try:
                self._terminate(node)
            except Exception as e:  # noqa: BLE001
                if self.recorder is not None:
                    self.recorder.publish(node, "TerminationError", str(e), type_="Warning")

    def _terminate(self, node) -> None:
        name = node.metadata.name
        # 1. taint so nothing new schedules, and pull the node out of
        # load-balancer target groups BEFORE draining starts — connections
        # must stop arriving before the instance disappears
        # (terminator.go:55-75; aws/karpenter#2518)
        needs_taint = not any(t.key == wk.DISRUPTED_TAINT_KEY for t in node.spec.taints)
        needs_lb_label = node.metadata.labels.get(EXCLUDE_BALANCERS_LABEL_KEY) != "karpenter"
        if needs_taint or needs_lb_label:
            def taint(n):
                if not any(t.key == wk.DISRUPTED_TAINT_KEY for t in n.spec.taints):
                    n.spec.taints.append(DISRUPTED_TAINT)
                n.metadata.labels[EXCLUDE_BALANCERS_LABEL_KEY] = "karpenter"

            self.store.patch("Node", name, taint)

        # 2. drain: evict by descending priority groups (terminator.go:96-138).
        # Pods that TOLERATE the disruption taint opted into riding the node
        # down — they are not evicted and are deleted with the instance
        # (podutils IsWaitingEviction; suite_test.go:225-288)
        bound = [p for p in self.store.list("Pod") if p.spec.node_name == name and pod_utils.is_active(p)]
        evictable = [p for p in bound if self._drainable(p)]
        tgp_expired = self._grace_period_expired(node)
        if evictable:
            pdb = PDBLimits(self.store)
            # evict the LOWEST priority group first; critical pods drain last
            # (terminator.go groupPodsByPriority / graceful-shutdown order)
            groups = sorted({(p.spec.priority or 0) for p in evictable})
            first = [p for p in evictable if (p.spec.priority or 0) == groups[0]]
            progressed = False
            for p in first:
                if not tgp_expired:
                    if pod_utils.is_eviction_blocked(p, self.clock.now()):
                        continue  # do-not-disrupt pods wait for TGP
                    ok, _ = pdb.can_evict(p)
                    if not ok:
                        continue
                    pdb.note_eviction(p)
                self._evict(p)
                progressed = True
            if not progressed and not tgp_expired:
                return  # blocked; retry next reconcile
            if len(evictable) > len(first) or not progressed:
                return  # more groups remain; drain continues next reconcile

        # recheck: everything evictable gone?
        still = [p for p in self.store.list("Pod") if p.spec.node_name == name and pod_utils.is_active(p) and self._drainable(p)]
        if still and not tgp_expired:
            return

        # 3. wait for VolumeAttachments of drain-able pods to detach before
        # the instance goes away, so PV-backed workloads can re-attach
        # elsewhere (controller.go:235-280 awaitVolumeDetachment); an elapsed
        # termination grace period skips the wait
        if not tgp_expired:
            pending = self._pending_volume_attachments(node)
            if pending:
                if self.recorder is not None:
                    self.recorder.publish(
                        node,
                        "AwaitingVolumeDetachment",
                        f"awaiting deletion of {len(pending)} volume attachment(s)",
                    )
                return

        # 4. delete daemon pods with the node
        for p in self.store.list("Pod"):
            if p.spec.node_name == name:
                self.store.try_delete("Pod", p.metadata.name, namespace=p.metadata.namespace)

        # 5. cloud delete + release finalizer (controller.go + [cloud boundary])
        claim = self._claim_for(node)
        if claim is not None:
            try:
                self.cloud_provider.delete(claim)
            except NodeClaimNotFoundError:
                pass
        self.store.remove_finalizer("Node", name, wk.TERMINATION_FINALIZER)
        if self.metrics is not None:
            from ... import metrics as m

            pool = node.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            zone = node.metadata.labels.get(wk.ZONE_LABEL_KEY, "")
            self.metrics.counter(m.NODES_TERMINATED_TOTAL).inc(nodepool=pool, zone=zone)
            if claim is not None:
                self.metrics.counter(m.NODECLAIMS_TERMINATED_TOTAL).inc(
                    nodepool=pool,
                    capacity_type=node.metadata.labels.get(wk.CAPACITY_TYPE_LABEL_KEY, ""),
                    zone=zone,
                )
        if self.recorder is not None:
            self.recorder.publish(node, "NodeTerminated", f"node {name} drained and terminated")

    def _pending_volume_attachments(self, node) -> list:
        """VolumeAttachments that must detach before instance deletion.
        Attachments whose PV backs a NON-drainable pod (do-not-disrupt,
        daemon/node-owned — pods that ride the node down) don't block
        (controller.go:309-355 filterVolumeAttachments)."""
        name = node.metadata.name
        vas = [va for va in self.store.list("VolumeAttachment") if va.node_name == name]
        if not vas:
            return []
        undrainable_pvs: set[str] = set()
        for p in self.store.list("Pod"):
            if p.spec.node_name != name or not pod_utils.is_active(p):
                continue
            if pod_utils.is_eviction_blocked(p, self.clock.now()) or not self._drainable(p):
                for v in p.spec.volumes:
                    ref = v.get("persistentVolumeClaim")
                    if not ref:
                        continue
                    pvc = self.store.try_get("PersistentVolumeClaim", ref.get("claimName", ""), p.metadata.namespace)
                    if pvc is not None and pvc.volume_name:
                        undrainable_pvs.add(pvc.volume_name)
        return [va for va in vas if va.persistent_volume_name not in undrainable_pvs]

    @staticmethod
    def _drainable(pod) -> bool:
        """Pods the drain evicts: not daemon/node-owned, and not tolerating
        the karpenter disrupted taint (tolerating pods ride the node down)."""
        if pod_utils.is_owned_by_daemonset(pod) or pod_utils.is_owned_by_node(pod):
            return False
        return taints_tolerate_pod([DISRUPTED_TAINT], pod) is not None

    def _evict(self, pod) -> None:
        """Evict = reset to pending (modeling controller recreation)."""

        def apply(p):
            p.spec.node_name = ""
            p.status.phase = "Pending"
            p.status.start_time = None

        self.store.patch("Pod", pod.metadata.name, apply, namespace=pod.metadata.namespace)

    def _grace_period_expired(self, node) -> bool:
        raw = node.metadata.annotations.get(wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY)
        if raw is None:
            return False
        try:
            return self.clock.now() >= float(raw)
        except ValueError:
            return False

    def _claim_for(self, node):
        for nc in self.store.list("NodeClaim"):
            if nc.status.provider_id and nc.status.provider_id == node.spec.provider_id:
                return nc
        return None
