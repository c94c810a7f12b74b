"""Provisioner: batch pending pods -> solve -> create NodeClaims.

Reference: provisioning/provisioner.go:127-513 — the singleton reconciler at
the top of call stack §3.1. The Solve step goes through the Solver plugin
point. The port's default is `solver.gpu.GPUSolver()`, on the CUDA device,
where the reference defaults to its host FFD; pass `solver=FFDSolver()` for
the host scheduler or `GPUSolver(device="cpu")` for the plain versions.

The port leaves out the metrics registry (passing one raises
`NotImplementedError`), the pod-event tracer and the serving loop's
pre-stager; `recorder` is None until events are ported.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...apis.nodepool import COND_NODEPOOL_READY
from ...solver.gpu import GPUSolver
from ...solver.snapshot import SolverSnapshot
from ...utils import pods as pod_utils
from .batcher import Batcher
from .scheduling.scheduler import Results


@dataclass
class ProvisionerOptions:
    preference_policy: str = "Respect"
    min_values_policy: str = "Strict"
    batch_idle_seconds: float = 1.0
    batch_max_seconds: float = 10.0
    capacity_buffer_enabled: bool = False  # CapacityBuffer feature gate
    dynamic_resources_enabled: bool = False  # DynamicResources feature gate
    reserved_capacity_enabled: bool = True  # ReservedCapacity feature gate


class Provisioner:
    def __init__(self, store, cluster, cloud_provider, clock, solver=None, recorder=None, options: ProvisionerOptions | None = None, metrics=None):
        if metrics is not None:
            raise NotImplementedError("provisioner metrics need the metrics registry, which is not ported")
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.solver = solver or GPUSolver()
        self.recorder = recorder
        self.options = options or ProvisionerOptions()
        self.batcher = Batcher(clock, self.options.batch_idle_seconds, self.options.batch_max_seconds)
        # watch-loss convergence: the store's Pod loss epoch seen at the last
        # reconcile. A bump means the delivered stream lost events the
        # Cluster mirror never saw — re-converge it from store content
        # before the next solve reads cluster state.
        self._watch_loss_seen = store.watch_loss_epoch("Pod") if hasattr(store, "watch_loss_epoch") else 0

    # -- triggering (provisioning/controller.go) -------------------------------
    def trigger(self, uid: str = "") -> None:
        self.batcher.trigger(uid)

    def reconcile(self, force: bool = False) -> Results | None:
        """One pass: fire when the batch window closes and state is synced.

        The solve is bracketed with the batcher's in-flight window so trigger
        bursts landing DURING it coalesce into exactly one batched follow-up
        solve (see Batcher)."""
        if not force and not self.batcher.ready():
            return None
        if not self.cluster.synced():
            return None
        # store content is authoritative: if the watch stream lost Pod
        # events since the last pass (any lossy transport), the event-fed
        # Cluster mirror is stale — re-converge it BEFORE the solve reads
        # node usage/bindings
        loss = self.store.watch_loss_epoch("Pod") if hasattr(self.store, "watch_loss_epoch") else 0
        if loss != self._watch_loss_seen:
            self._watch_loss_seen = loss
            self.cluster.resync_pods()
        # one atomic handoff: close the generation and open the in-flight
        # window together, so a concurrent trigger can never fall between
        self.batcher.take_generation()
        try:
            results = self.provision()
        finally:
            self.batcher.end_solve()
        return results

    # -- the provisioning pass (provisioner.go:350-458) ------------------------
    def provision(self) -> Results:
        pods = self.get_pending_pods()
        results = self.schedule(pods)
        for claim in results.new_node_claims:
            if claim.pods:
                self.create_node_claim(claim)
        # nominate existing nodes that received pods so disruption leaves them be
        for existing in results.existing_nodes:
            if existing.pods:
                self.cluster.nominate_node(existing.name())
        if self.options.capacity_buffer_enabled:
            self._record_buffer_pod_counts(results)
        return results

    def _record_buffer_pod_counts(self, results: Results) -> None:
        """Which nodes host virtual buffer pods this round — emptiness must
        not reclaim them (provisioner.go:156, cluster.go:299-307)."""
        from ...apis.capacitybuffer import is_virtual_pod

        counts: dict[str, int] = {}
        for existing in results.existing_nodes:
            n = sum(1 for p in existing.pods if is_virtual_pod(p))
            if n:
                counts[existing.state_node.provider_id()] = n
        self.cluster.update_buffer_pod_counts(counts)

    def get_pending_pods(self) -> list:
        """Provisionable pods (provisioner.go:192-221); pods referencing
        invalid PVCs are skipped the way kube-scheduler rejects them
        (provisioner.go:556-566)."""
        from .scheduling.volumetopology import VolumeTopology

        from ...kube.clone import fast_deepcopy

        vt = VolumeTopology(self.store)
        out = []
        # filter over the borrowed cache view (most pods are bound — cloning
        # the full list per call dominated at reference scale), then clone
        # only the survivors: the store may mutate them between solves
        for pod in self.store.borrow_list("Pod"):
            if not pod_utils.is_provisionable(pod):
                continue
            verr = vt.validate_persistent_volume_claims(pod)
            if verr is not None:
                if self.recorder is not None:
                    self.recorder.publish(pod, "FailedScheduling", f"ignoring pod, {verr}", type_="Warning")
                continue
            out.append(fast_deepcopy(pod))
        # CapacityBuffer virtual pods join AFTER validation so they skip PVC
        # checks and never round-trip through the store (buffers.go:37-87)
        if self.options.capacity_buffer_enabled:
            out = self._append_virtual_pods(out)
        return out

    def _append_virtual_pods(self, pods: list) -> list:
        from ...apis.capacitybuffer import COND_READY_FOR_PROVISIONING
        from ..capacitybuffer.controller import build_virtual_pods, resolve_buffer_pod_spec

        for cb in self.store.list("CapacityBuffer"):
            if not cb.status.conditions.is_true(COND_READY_FOR_PROVISIONING):
                continue
            if not cb.status.replicas or cb.status.replicas <= 0:
                continue
            spec, template_labels = resolve_buffer_pod_spec(self.store, cb)
            if spec is None:
                continue
            pods = pods + build_virtual_pods(cb, spec, template_labels)
        return pods

    def schedule(self, pods: list) -> Results:
        if not pods:
            return Results()
        snapshot = self.make_snapshot(pods)
        # computing effective zones is pointless when nobody publishes them
        snapshot.collect_zone_metrics = False
        if not snapshot.node_pools:
            return Results(pod_errors={p.key(): "no ready nodepools" for p in pods})
        return self.solver.solve(snapshot)

    def make_snapshot(self, pods: list, state_nodes=None, exclude_deleting: bool = True) -> SolverSnapshot:
        """Snapshot assembly (provisioner.go:261-348 NewScheduler)."""
        # skip static pools, deleting pools, and pools an aux controller has
        # explicitly marked not-Ready (provisioner.go:272-281; absence of the
        # condition counts ready so direct-wired tests need no readiness pass)
        node_pools = [
            np
            for np in self.store.list("NodePool")
            if not np.is_static()
            and np.metadata.deletion_timestamp is None
            and not np.status.conditions.is_false(COND_NODEPOOL_READY)
        ]
        instance_types = {}
        for np in node_pools:
            its = self.cloud_provider.get_instance_types(np)
            if its:
                instance_types[np.metadata.name] = its
        node_pools = [np for np in node_pools if np.metadata.name in instance_types]
        if state_nodes is None:
            state_nodes = [
                n
                for n in self.cluster.nodes()
                if not (exclude_deleting and (n.marked_for_deletion or n.deleted()))
            ]
        daemonset_pods = [ds.to_pod() for ds in self.store.list("DaemonSet")]
        return SolverSnapshot(
            store=self.store,
            cluster=self.cluster,
            node_pools=node_pools,
            instance_types=instance_types,
            state_nodes=state_nodes,
            daemonset_pods=daemonset_pods,
            pods=pods,
            clock=self.clock,
            preference_policy=self.options.preference_policy,
            min_values_policy=self.options.min_values_policy,
            dra_enabled=self.options.dynamic_resources_enabled,
            reserved_capacity_enabled=self.options.reserved_capacity_enabled,
        )

    def create_node_claim(self, scheduling_claim) -> str | None:
        """Limits check + API create (provisioner.go:460-513). Returns the
        created claim name or None when limits forbid it."""
        nc = scheduling_claim.to_api_node_claim(self.clock)
        pool_name = scheduling_claim.nodepool_name if hasattr(scheduling_claim, "nodepool_name") else scheduling_claim.template.nodepool_name
        node_pool = self.store.try_get("NodePool", pool_name)
        if node_pool is None:
            return None
        if node_pool.spec.limits:
            # reject when current usage already exceeds limits (provisioner.go
            # Create: ExceededBy(current)); forward-looking enforcement happens
            # in the scheduler via remainingResources filtering
            current = self.cluster.nodepool_resources(pool_name)
            err = node_pool.limits_exceeded_by(current)
            if err is not None:
                return None
        created = self.store.create(nc)
        # immediately mirror into cluster state so the next solve sees it, and
        # nominate it so emptiness doesn't reclaim capacity (e.g. a node built
        # purely for buffer headroom) before the next pass records its pods
        self.cluster.update_node_claim(created)
        self.cluster.nominate_claim(created.metadata.name)
        return created.metadata.name
