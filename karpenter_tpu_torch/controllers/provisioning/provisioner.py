"""Provisioner: batch pending pods -> solve -> create NodeClaims.

Reference: provisioning/provisioner.go:127-513 — the singleton reconciler at
the top of call stack §3.1. The Solve step goes through the Solver plugin
point. The port's default is `solver.gpu.GPUSolver()`, on the CUDA device,
where the reference defaults to its host FFD; pass `solver=FFDSolver()` for
the host scheduler or `GPUSolver(device="cpu")` for the plain versions.

`metrics` (a `metrics.Registry`) receives the reference's provisioning
counters, gauges and histograms; `podtracer` (an `obs.podtrace.PodTracer`)
stamps dispatch and solve on every traced pod of a batch. With a serving
loop's pre-stager installed (`prestager`, a `serving.prestage.
PendingPrestager`), `get_pending_pods` takes its staged clones.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...apis import labels as wk
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
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.solver = solver or GPUSolver()
        self.recorder = recorder
        self.options = options or ProvisionerOptions()
        self.metrics = metrics
        self.batcher = Batcher(clock, self.options.batch_idle_seconds, self.options.batch_max_seconds)
        # bounded fleet tenant label (serving.fleet.tenant_label output, set
        # by FleetFrontend at session registration): rides the churn metric
        # families so one shared fleet registry attributes them per tenant.
        # "" outside a fleet — the registry renders that as the empty label.
        self.tenant = ""
        # podtrace (obs/podtrace.py): the event-lifecycle tracer, installed
        # by the Environment — provision() stamps dispatch/solved on every
        # traced pod in the batch and links the batch summary into the
        # SolveTrace. None = untraced provisioner (direct-wired tests).
        self.podtracer = None
        # serving-loop double-buffer (serving/prestage.py): when installed,
        # get_pending_pods consumes pre-staged pod clones (already validated
        # and signature-stamped, by the worker that overlapped the previous
        # solve's device pack) instead of cloning inline; None = the
        # reference clone-per-pass behavior
        self.prestager = None
        # watch-loss convergence (faultline): the store's Pod loss epoch
        # seen at the last reconcile. A bump means the delivered stream
        # lost events the Cluster mirror never saw — re-converge it from
        # store content before the next solve reads cluster state.
        self._watch_loss_seen = store.watch_loss_epoch("Pod") if hasattr(store, "watch_loss_epoch") else 0

    # -- triggering (provisioning/controller.go) -------------------------------
    def trigger(self, uid: str = "") -> None:
        self.batcher.trigger(uid)

    def reconcile(self, force: bool = False) -> Results | None:
        """One pass: fire when the batch window closes and state is synced.

        The solve is bracketed with the batcher's in-flight window so trigger
        bursts landing DURING it coalesce into exactly one batched follow-up
        solve (see Batcher); the karpenter_solver_churn_* families record the
        coalescing behavior per solve."""
        if not force and not self.batcher.ready():
            return None
        if not self.cluster.synced():
            return None
        # store content is authoritative: if the watch stream lost Pod
        # events since the last pass (faultline watch-drop, or any real
        # lossy transport), the event-fed Cluster mirror is stale —
        # re-converge it BEFORE the solve reads node usage/bindings
        loss = self.store.watch_loss_epoch("Pod") if hasattr(self.store, "watch_loss_epoch") else 0
        if loss != self._watch_loss_seen:
            self._watch_loss_seen = loss
            self.cluster.resync_pods()
            if self.metrics is not None:
                from ... import metrics as m

                self.metrics.counter(m.SOLVER_WATCH_RESYNC_TOTAL).inc()
        # one atomic handoff: close the generation and open the in-flight
        # window together, so a concurrent trigger can never fall between
        events = self.batcher.take_generation()
        try:
            results = self.provision()
        finally:
            coalesced = self.batcher.end_solve()
            if self.metrics is not None:
                from ... import metrics as m

                if coalesced:
                    self.metrics.counter(m.SOLVER_CHURN_COALESCED_TOTAL).inc(coalesced, tenant=self.tenant)  # solverlint: ok(metric-label-cardinality): tenant is a serving.fleet.tenant_label() output stored at fleet registration — the bounded fleet enum ("" outside a fleet)
                self.metrics.histogram(m.SOLVER_CHURN_EVENTS_PER_SOLVE).observe(float(events), tenant=self.tenant)  # solverlint: ok(metric-label-cardinality): tenant is a serving.fleet.tenant_label() output stored at fleet registration — the bounded fleet enum ("" outside a fleet)
                # depth AFTER the solve: the coalesced generation still queued
                self.metrics.gauge(m.SOLVER_CHURN_QUEUE_DEPTH).set(self.batcher.pending(), tenant=self.tenant)  # solverlint: ok(metric-label-cardinality): tenant is a serving.fleet.tenant_label() output stored at fleet registration — the bounded fleet enum ("" outside a fleet)
        return results

    # -- the provisioning pass (provisioner.go:350-458) ------------------------
    def provision(self) -> Results:
        pods = self.get_pending_pods()
        # podtrace dispatch stamp: the generation was just taken and its
        # batch assembled — every traced event's coalescing-window residency
        # ends HERE, and the batch summary rides the SolveTrace (explain()
        # joins the two views through the solve seq)
        tracer = self.podtracer
        if tracer is not None and tracer.enabled:
            batch = tracer.on_dispatch(pods, window=self.batcher.last_generation())
            if batch is not None and hasattr(self.solver, "stage_event_batch"):
                self.solver.stage_event_batch(batch)
        results = self.schedule(pods)
        if tracer is not None and tracer.enabled:
            tracer.on_solved(results, solve_seq=getattr(getattr(self.solver, "_trace", None), "seq", 0))
            if hasattr(self.solver, "discard_event_batch"):
                # schedule() may have declined to solve (no pods / no ready
                # nodepools): a staged batch the solve never consumed must
                # not attach to a later, unrelated solve's trace
                self.solver.discard_event_batch()
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
        prestager = self.prestager
        out = []
        # filter over the borrowed cache view (most pods are bound — cloning
        # the full list per call dominated at reference scale), then clone
        # only the survivors: the store may mutate them between solves. With
        # a prestager installed (serving loop), the clone+validate work for
        # unchanged pods was already done — typically overlapped with the
        # PREVIOUS solve's device pack — and the SAME clone object is reused
        # while (uid, resourceVersion) holds, which is what lets the encoder
        # classify consecutive serving snapshots as pod deltas
        for pod in self.store.borrow_list("Pod"):
            if not pod_utils.is_provisionable(pod):
                continue
            if prestager is not None:
                clone = prestager.take(pod)
                if clone is not None:
                    # staged pods carry no claim-backed volumes, so the PVC
                    # validation below is a provable no-op for them
                    out.append(clone)
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
            if self.metrics is not None:
                from ... import metrics as m

                self.metrics.gauge(m.SCHEDULER_QUEUE_DEPTH).set(0)
                self.metrics.gauge(m.SCHEDULER_UNSCHEDULABLE_PODS).set(0)
                self.metrics.gauge(m.SCHEDULER_PENDING_PODS_BY_EFFECTIVE_ZONE).reset()
            return Results()
        snapshot = self.make_snapshot(pods)
        # computing effective zones is pointless when nobody publishes them
        snapshot.collect_zone_metrics = self.metrics is not None
        if not snapshot.node_pools:
            if self.metrics is not None:
                from ... import metrics as m

                # no solve runs, so every solve-scoped gauge would otherwise
                # keep reporting the previous batch forever
                self.metrics.gauge(m.SCHEDULER_QUEUE_DEPTH).set(len(pods))
                self.metrics.gauge(m.SCHEDULER_UNSCHEDULABLE_PODS).set(len(pods))
                self.metrics.gauge(m.SCHEDULER_PENDING_PODS_BY_EFFECTIVE_ZONE).reset()
            return Results(pod_errors={p.key(): "no ready nodepools" for p in pods})
        if self.metrics is None:
            return self.solver.solve(snapshot)
        import time as _time

        from ... import metrics as m

        self.metrics.gauge(m.SCHEDULER_QUEUE_DEPTH).set(len(pods))
        t0 = _time.perf_counter()
        results = self.solver.solve(snapshot)
        self.metrics.histogram(m.SCHEDULER_SCHEDULING_DURATION).observe(_time.perf_counter() - t0)
        # unschedulable virtual buffer pods are headroom shortfall, not real
        # demand failures (buffers.go filterVirtualPodErrors)
        from ...apis.capacitybuffer import is_virtual_pod

        virtual_keys = {p.key() for p in pods if is_virtual_pod(p)}
        real_errors = {k: v for k, v in results.pod_errors.items() if k not in virtual_keys}
        self.metrics.gauge(m.SCHEDULER_UNSCHEDULABLE_PODS).set(len(real_errors))
        # effective-zone demand gauge (scheduler.go:450,495-501): stale zone
        # labels are dropped each solve, then the batch's counts published; a
        # backend that does not compute the counts (TPU decode) clears the
        # gauge too, so it never reports a previous batch
        g = self.metrics.gauge(m.SCHEDULER_PENDING_PODS_BY_EFFECTIVE_ZONE)
        g.reset()
        for zone, count in (results.pending_pods_by_effective_zone or {}).items():
            g.set(count, zone=zone)
        return results

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
            registry=self.metrics,
        )

    def create_node_claim(self, scheduling_claim, reason: str = "provisioning") -> str | None:
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
        if self.metrics is not None:
            from ... import metrics as m

            relaxed = wk.NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY in nc.metadata.annotations
            self.metrics.counter(m.NODECLAIMS_CREATED_TOTAL).inc(
                reason=reason, nodepool=pool_name, min_values_relaxed=str(relaxed).lower()  # solverlint: ok(metric-label-cardinality): reason is a parameter whose call sites pass fixed literals ("provisioning", "static_provisioned") or a disruption command reason — all enum-bounded
            )
        return created.metadata.name
