"""NodeClaim lifecycle: Launch -> Registration -> Initialization -> Liveness.

Reference: nodeclaim/lifecycle/{controller,launch,registration,initialization,
liveness}.go (call stack SURVEY.md §3.3). Each phase is an idempotent
sub-reconciler flipping a status condition; conditions are the durable
checkpoints of the system.
"""

from __future__ import annotations

from ...apis import labels as wk
from ...apis.nodeclaim import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
    NodeClaim,
)
from ...cloudprovider.errors import InsufficientCapacityError, NodeClassNotReadyError
from ...kube.objects import OwnerReference
from ...kube.store import NotFound
from ...scheduling.taints import is_known_ephemeral_taint
from ...utils import resources as res

REGISTRATION_TTL_SECONDS = 15 * 60  # liveness.go:39 registrationTTL
LAUNCH_TIMEOUT_SECONDS = 5 * 60  # liveness.go:57-59 LaunchTimeout


class LifecycleController:
    def __init__(self, store, cluster, cloud_provider, clock, recorder=None, np_state=None, metrics=None, registration_hooks=None):
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        self.np_state = np_state  # nodepoolhealth.NodePoolHealthState
        self.metrics = metrics
        # provider-supplied registration gates: each hook has .name and
        # .registered(node_claim) -> bool; ALL must pass before the
        # unregistered taint drops (cloudprovider types.go:111-118
        # NodeLifecycleHook, controllers.go:78-84 WithRegistrationHook)
        self.registration_hooks = list(registration_hooks or [])

    def reconcile_all(self) -> None:
        for nc in self.store.borrow_list("NodeClaim"):
            # per-item error isolation (controller-runtime semantics: a
            # reconcile error requeues THAT item; it never kills the manager)
            # — a cloud-provider outage on one claim must not stall the fleet
            try:
                self.reconcile(nc.metadata.name)
            except Exception as e:  # noqa: BLE001
                if self.recorder is not None:
                    self.recorder.publish(nc, "ReconcileError", str(e), type_="Warning")

    def reconcile(self, name: str) -> None:
        try:
            nc = self.store.get("NodeClaim", name)
        except NotFound:
            return
        if nc.metadata.deletion_timestamp is not None:
            self._terminate(nc)
            return
        changed = False
        changed |= self._launch(nc)
        changed |= self._register(nc)
        changed |= self._initialize(nc)
        if changed:
            try:
                self.store.update(nc)
                self.cluster.update_node_claim(nc)
            except NotFound:
                return
        self._liveness(nc)

    # -- Launch (launch.go): cloudProvider.Create -> providerID ----------------
    def _launch(self, nc: NodeClaim) -> bool:
        if nc.is_launched() or nc.status.provider_id:
            return False
        try:
            created = self.cloud_provider.create(nc)
        except InsufficientCapacityError as e:
            # terminal for this claim: delete so the provisioner retries
            nc.status.conditions.set_false(COND_LAUNCHED, "InsufficientCapacity", str(e), now=self.clock.now())
            self.store.update(nc)
            self.store.delete("NodeClaim", nc.metadata.name, grace=False)
            return False
        except NodeClassNotReadyError as e:
            nc.status.conditions.set_false(COND_LAUNCHED, "NodeClassNotReady", str(e), now=self.clock.now())
            return True
        nc.status.provider_id = created.status.provider_id
        nc.status.image_id = created.status.image_id
        nc.status.capacity = dict(created.status.capacity)
        nc.status.allocatable = dict(created.status.allocatable)
        # adopt resolved labels (instance type, zone, capacity type)
        for k, v in created.metadata.labels.items():
            nc.metadata.labels.setdefault(k, v)
        nc.status.conditions.set_true(COND_LAUNCHED, now=self.clock.now())
        return True

    # -- Registration (registration.go): node with matching providerID joined --
    def _register(self, nc: NodeClaim) -> bool:
        if nc.is_registered() or not nc.is_launched():
            return False
        node = self._node_for(nc)
        if node is None:
            # anchor the registration-timeout window at the condition's
            # transition time, not the claim's creation (registration.go:68
            # SetUnknownWithReason; liveness_test.go:264)
            return nc.status.conditions.set(
                COND_REGISTERED, "Unknown", "NodeNotFound",
                "Node not registered with cluster", now=self.clock.now(),
            )
        # every registration hook must pass before the unregistered taint
        # drops; until then the sync still runs (labels/annotations/taints)
        # but the node stays unschedulable (registration.go:93-116)
        pending_hooks = [h.name for h in self.registration_hooks if not h.registered(nc)]

        # sync labels/taints/annotations from the claim onto the node; drop
        # the unregistered taint only once the hooks clear
        def apply(n):
            # the claim owns its node (nodeclaim.go:271-287
            # UpdateNodeOwnerReferences; registration_test.go:142-196) —
            # added once, keyed on the claim's uid
            if not any(
                ref.kind == "NodeClaim" and ref.uid == nc.metadata.uid
                for ref in n.metadata.owner_references
            ):
                n.metadata.owner_references.append(
                    OwnerReference(
                        kind="NodeClaim",
                        name=nc.metadata.name,
                        uid=nc.metadata.uid,
                        api_version="karpenter.sh/v1",
                        block_owner_deletion=True,
                    )
                )
            for k, v in nc.metadata.labels.items():
                n.metadata.labels.setdefault(k, v)
            for k, v in nc.metadata.annotations.items():
                n.metadata.annotations.setdefault(k, v)
            # a provider that manages taints itself sets do-not-sync-taints;
            # the unregistered taint is still ours to remove
            # (registration.go:211-217)
            if n.metadata.labels.get(wk.NODE_DO_NOT_SYNC_TAINTS_LABEL_KEY) != "true":
                existing = {(t.key, t.effect) for t in n.spec.taints}
                for t in list(nc.spec.taints) + list(nc.spec.startup_taints):
                    if (t.key, t.effect) not in existing:
                        n.spec.taints.append(t)
            if not pending_hooks:
                n.metadata.labels[wk.NODE_REGISTERED_LABEL_KEY] = "true"
                n.spec.taints = [t for t in n.spec.taints if t.key != wk.UNREGISTERED_TAINT_KEY]
            if wk.TERMINATION_FINALIZER not in n.metadata.finalizers:
                n.metadata.finalizers.append(wk.TERMINATION_FINALIZER)

        self.store.patch("Node", node.metadata.name, apply)
        if pending_hooks:
            # UNKNOWN like the node-missing state (registration.go:171
            # SetUnknownWithReason): flipping to False here would bounce the
            # Registered status Unknown↔False as nodes come and go, resetting
            # the liveness anchor each time and letting a never-registering
            # claim evade the TTL. Transition-only return keeps a steadily
            # unready hook from writing the claim every round.
            return nc.status.conditions.set(
                COND_REGISTERED,
                "Unknown",
                "RegistrationHookPending",
                f"waiting on registration hooks: {', '.join(sorted(pending_hooks))}",
                now=self.clock.now(),
            )
        nc.status.node_name = node.metadata.name
        nc.status.conditions.set_true(COND_REGISTERED, now=self.clock.now())
        self._record_registration_outcome(nc, success=True)
        if self.metrics is not None:
            from ... import metrics as m

            self.metrics.counter(m.NODES_CREATED_TOTAL).inc(
                nodepool=nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
                zone=nc.metadata.labels.get(wk.ZONE_LABEL_KEY, ""),
            )
        return True

    # -- Initialization (initialization.go): node ready + resources registered -
    def _initialize(self, nc: NodeClaim) -> bool:
        if nc.is_initialized() or not nc.is_registered():
            return False
        node = self.store.try_get("Node", nc.status.node_name)
        if node is None:
            return False
        if not _node_ready(node):
            return False
        # startup taints must have cleared — MatchTaint (key + effect)
        # semantics, consistent with StateNode.taints()' scheduling filter
        startup = {(t.key, t.effect) for t in nc.spec.startup_taints}
        if any((t.key, t.effect) in startup for t in node.spec.taints):
            return False
        # known EPHEMERAL taints must have lifted too: not-ready/unreachable/
        # cloud-provider-uninitialized and readiness.k8s.io/ controller gates
        # (initialization.go:78-79,104-112 KnownEphemeralTaintsRemoved)
        if any(is_known_ephemeral_taint(t) for t in node.spec.taints):
            return False
        # every non-zero requested resource must be REGISTERED on the node:
        # kubelet zeroes extended resources at startup, so a zero allocatable
        # for a requested resource means the device plugin hasn't published
        # yet (initialization.go:131-146 RequestedResourcesRegistered)
        for name, q in nc.spec.resources.items():
            if name == "pods" or q.milli == 0:
                continue
            have = node.status.allocatable.get(name)
            if have is None or have.milli == 0:
                return False

        def apply(n):
            n.metadata.labels[wk.NODE_INITIALIZED_LABEL_KEY] = "true"

        self.store.patch("Node", node.metadata.name, apply)
        nc.status.conditions.set_true(COND_INITIALIZED, now=self.clock.now())
        return True

    # -- Liveness (liveness.go:62): kill claims that never register ------------
    def _liveness(self, nc: NodeClaim) -> None:
        if nc.is_registered():
            return
        now = self.clock.now()
        launched = nc.status.conditions.get(COND_LAUNCHED)
        # a claim stuck UNLAUNCHED dies on the (shorter) launch timeout,
        # measured from the Launched condition's transition — not the
        # claim's creation (liveness.go:66-88, liveness_test.go:224)
        if launched is not None and launched.status != "True":
            if now - launched.last_transition_time > LAUNCH_TIMEOUT_SECONDS:
                self._record_registration_outcome(nc, success=False)
                self.store.try_delete("NodeClaim", nc.metadata.name)
            return
        registered = nc.status.conditions.get(COND_REGISTERED)
        # registration timeout anchors at the Registered condition's
        # transition (set Unknown when the node hasn't joined); claims
        # predating that anchor fall back to creation time
        # (liveness.go:90-103, liveness_test.go:264)
        anchor = (
            registered.last_transition_time
            if registered is not None
            else nc.metadata.creation_timestamp
        )
        if now - anchor > REGISTRATION_TTL_SECONDS:
            self._record_registration_outcome(nc, success=False)
            self.store.try_delete("NodeClaim", nc.metadata.name)

    def _record_registration_outcome(self, nc: NodeClaim, success: bool) -> None:
        """Feed the per-pool health tracker and flip NodeRegistrationHealthy
        when the windowed outcome crosses the threshold (registration.go:178-200,
        liveness.go:113-145)."""
        if self.np_state is None or not nc.nodepool_name:
            return
        pool = self.store.try_get("NodePool", nc.nodepool_name)
        if pool is None:
            return
        from ...apis.nodepool import COND_NODE_REGISTRATION_HEALTHY
        from ...state import nodepoolhealth

        uid = pool.metadata.uid
        self.np_state.update(uid, success)
        status = self.np_state.status(uid)
        if success:
            if status == nodepoolhealth.STATUS_HEALTHY and not pool.status.conditions.is_true(
                COND_NODE_REGISTRATION_HEALTHY
            ):
                def apply(obj):
                    obj.status.conditions.set_true(COND_NODE_REGISTRATION_HEALTHY, now=self.clock.now())

                self.store.patch("NodePool", pool.metadata.name, apply)
        else:
            if status == nodepoolhealth.STATUS_UNHEALTHY and not pool.status.conditions.is_false(
                COND_NODE_REGISTRATION_HEALTHY
            ):
                launched = nc.status.conditions.get("Launched")
                if launched is not None and launched.status != "True":
                    reason, message = launched.reason, launched.message
                else:
                    reason, message = "RegistrationFailed", "Failed to register node"

                def apply(obj, reason=reason, message=message):
                    obj.status.conditions.set_false(COND_NODE_REGISTRATION_HEALTHY, reason, message, now=self.clock.now())

                self.store.patch("NodePool", pool.metadata.name, apply)

    # -- claim termination (lifecycle/termination.go): node drained first (the
    # node termination controller owns the drain), then instance gone, then
    # the claim finalizer is released.
    def _terminate(self, nc: NodeClaim) -> None:
        from ...cloudprovider.errors import NodeClaimNotFoundError

        # only REGISTERED claims drain through their Node objects — an
        # unregistered node has no synced kubelet state worth draining and
        # deleting it risks leaked leases, so the instance is terminated
        # directly and the node is garbage collected (controller.go:210-232)
        if nc.is_registered():
            nodes = []
            if nc.status.node_name:
                n = self.store.try_get("Node", nc.status.node_name)
                if n is not None:
                    nodes.append(n)
            if nc.status.provider_id:
                # EVERY node mapping to the claim goes (duplicate-node
                # invariant violations, termination_test.go:233); borrowed
                # scan — only names/timestamps are read, patches go by name
                for n in self.store.borrow_list("Node"):
                    if n.spec.provider_id == nc.status.provider_id and all(
                        n.metadata.name != m.metadata.name for m in nodes
                    ):
                        nodes.append(n)
            for node in nodes:
                if node.metadata.deletion_timestamp is not None:
                    continue  # already terminating; don't re-delete
                # stamp the forced-drain deadline so terminationGracePeriod
                # can override blocked PDBs / do-not-disrupt
                # (termination.go TGP)
                if nc.spec.termination_grace_period is not None:
                    deadline = self.clock.now() + nc.spec.termination_grace_period
                    # an earlier deadline already stamped (e.g. by node
                    # repair's force-drain) wins; never extend it
                    existing = nc.metadata.annotations.get(wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY)
                    if existing is not None:
                        deadline = min(deadline, float(existing))

                    def stamp(n):
                        cur = n.metadata.annotations.get(wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY)
                        if cur is None or float(cur) > deadline:
                            n.metadata.annotations[wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY] = str(deadline)

                    self.store.patch("Node", node.metadata.name, stamp)
                self.store.try_delete("Node", node.metadata.name)  # graceful: drain runs
            if nodes:
                return  # wait until ALL nodes finish draining (controller.go:228-231)
        if nc.status.provider_id:
            try:
                self.cloud_provider.delete(nc)
            except NodeClaimNotFoundError:
                pass
        self.store.remove_finalizer("NodeClaim", nc.metadata.name, wk.TERMINATION_FINALIZER)

    def _node_for(self, nc: NodeClaim):
        # borrowed scan to find the match, clone only the hit (callers mutate
        # the returned node and write it back)
        for node in self.store.borrow_list("Node"):
            if node.spec.provider_id == nc.status.provider_id:
                return self.store.get("Node", node.metadata.name)
        return None


def _node_ready(node) -> bool:
    for c in node.status.conditions:
        if c.type == "Ready":
            return c.status == "True"
    return True  # KWOK nodes have no kubelet; absence of conditions counts ready
