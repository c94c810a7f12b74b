"""Environment: the full wiring of the control plane, plus a deterministic
tick() driver.

Plays the role of the reference's NewOperator + controller manager
(operator.go:126-252 and controllers.go:87-196), but clock-driven: tests and
the simulation harness advance time explicitly and call tick(), which runs one
round of every controller in dependency order. A wall-clock run loop is a
thin loop over tick() + clock sleeps.

The provisioner's solver follows `Options.solver_backend`: "gpu" (the
default) is `GPUSolver` on `device` (None: the CUDA device, which raises
without CUDA; "cpu" runs the plain versions), "ffd" the host `FFDSolver`.
Multi-node consolidation's LP proposer runs on the same device.
"""

from __future__ import annotations

from ..apis.kwoknodeclass import KWOKNodeClass
from ..cloudprovider import catalog
from ..cloudprovider.kwok import KWOKCloudProvider
from ..cloudprovider.metrics import MetricsCloudProvider
from ..cloudprovider.overlay import OverlayCloudProvider
from ..controllers.disruption import DisruptionController
from ..controllers.nodeclaim.consistency import ConsistencyController
from ..controllers.nodeclaim.disruption import NodeClaimDisruptionController
from ..controllers.nodeclaim.expiration import ExpirationController
from ..controllers.nodeclaim.hydration import HydrationController
from ..controllers.nodeclaim.podevents import PodEventsController
from ..controllers.node.health import HealthController
from ..controllers.node.termination import TerminationController
from ..controllers.nodeclaim.garbagecollection import GarbageCollectionController
from ..controllers.nodeclaim.lifecycle import LifecycleController
from ..controllers.nodepool import (
    NodePoolCounterController,
    NodePoolHashController,
    NodePoolReadinessController,
    NodePoolRegistrationHealthController,
    NodePoolValidationController,
)
from ..controllers.nodeoverlay import InstanceTypeStore, NodeOverlayController
from ..controllers.provisioning.provisioner import Provisioner, ProvisionerOptions
from ..controllers.capacitybuffer import CapacityBufferController
from ..controllers.dynamicresources import DeviceAllocationController, DRAKwokDriver
from ..controllers.static import StaticDeprovisioningController, StaticProvisioningController
from ..controllers.metrics import (
    NodeMetricsController,
    NodePoolMetricsController,
    PodMetricsController,
)
from ..events import Recorder
from ..kube import Store
from ..kube.binder import Binder
from ..kube.daemonsets import DaemonSetRunner
from ..metrics import make_registry
from ..solver.ffd import FFDSolver
from ..state import Cluster
from ..state.cost import ClusterCost, PricingController, start_cost_informer
from ..state.informer import start_informers
from ..state.nodepoolhealth import NodePoolHealthState
from ..utils.clock import Clock, FakeClock
from .options import Options


class Environment:
    """A fully wired in-process cluster + Karpenter control plane."""

    def __init__(self, options: Options | None = None, clock=None, cloud_provider=None, instance_types=None, store=None, registration_hooks=None, registry=None,
                 device=None):
        """`store` lets a second Environment attach to an existing cluster
        (active/standby takeover tests): informers seed the fresh in-memory
        mirror from the shared store's current content, exactly like a new
        leader warming its caches (operator.go:196-201). `registry` lets the
        fleet front-end share ONE metrics registry across its per-tenant
        environments (per-tenant series split on the bounded `tenant`
        label); default is a private registry per environment. `device` is
        the GPU solver's (None: the CUDA device)."""
        self.options = options or Options()
        self.clock = clock or FakeClock()
        self.registry = registry if registry is not None else make_registry()
        # solvetrace flight recorder backing /debug/solves — the process-wide
        # default, so every solver this environment (or a test beside it)
        # runs is visible from the operator's debug surface
        from ..obs.trace import default_recorder

        self.trace_recorder = default_recorder()
        # podtrace event-lifecycle tracer backing /debug/events (obs/
        # podtrace.py, default-on via KARPENTER_PODTRACE): stamped into the
        # store's delivery seam below and into the provisioner after it is
        # built. Per-environment (= per-tenant in fleet mode; the fleet
        # relabels it at session registration).
        from ..obs.podtrace import PodTracer

        self.podtracer = PodTracer(registry=self.registry)
        self.recorder = Recorder(self.clock)
        self.store = store if store is not None else Store(clock=self.clock)
        if self.podtracer.enabled:
            self.store.set_event_tracer(self.podtracer)
        self.cluster = Cluster(self.store, self.clock)
        start_informers(self.store, self.cluster)

        if cloud_provider is not None:
            base_cloud_provider = cloud_provider
        else:
            its = instance_types if instance_types is not None else catalog.construct_instance_types()
            if self.store.try_get("KWOKNodeClass", KWOKNodeClass().metadata.name) is None:
                self.store.create(KWOKNodeClass())
            base_cloud_provider = KWOKCloudProvider(self.store, its, clock=self.clock)
        # decorator stack (kwok/main.go:36-37 + cloudprovider/metrics): the
        # overlay controller reads the undecorated provider; everyone else the
        # overlay+metrics-decorated one
        self.base_cloud_provider = base_cloud_provider
        self.instance_type_store = InstanceTypeStore()
        self.cloud_provider = MetricsCloudProvider(
            OverlayCloudProvider(base_cloud_provider, self.instance_type_store, self.options), self.registry
        )
        self.nodeoverlay = NodeOverlayController(
            self.store, base_cloud_provider, self.instance_type_store, self.cluster, self.clock,
            options=self.options,
        )

        self.cluster_cost = ClusterCost(self.store, self.cloud_provider, metrics=self.registry)
        start_cost_informer(self.store, self.cluster_cost)
        self.pricing = PricingController(self.store, self.cloud_provider, self.cluster_cost, self.clock)

        solver = self._make_solver(device)
        self.provisioner = Provisioner(
            self.store,
            self.cluster,
            self.cloud_provider,
            self.clock,
            solver=solver,
            recorder=self.recorder,
            metrics=self.registry,
            options=ProvisionerOptions(
                preference_policy=self.options.preference_policy,
                min_values_policy=self.options.min_values_policy,
                batch_idle_seconds=self.options.batch_idle_duration,
                batch_max_seconds=self.options.batch_max_duration,
                capacity_buffer_enabled=self.options.feature_gates.capacity_buffer,
                dynamic_resources_enabled=self.options.feature_gates.dynamic_resources,
                reserved_capacity_enabled=self.options.feature_gates.reserved_capacity,
            ),
        )
        self.provisioner.podtracer = self.podtracer
        self.device_allocation = DeviceAllocationController(self.store, self.cluster, self.clock)
        self.dra_kwok_driver = DRAKwokDriver(self.store)
        self.capacity_buffer = CapacityBufferController(self.store, self.clock, provisioner=self.provisioner)
        self.static_provisioning = StaticProvisioningController(
            self.store, self.cluster, self.cloud_provider, self.provisioner, self.clock, metrics=self.registry
        )
        self.static_deprovisioning = StaticDeprovisioningController(
            self.store, self.cluster, self.cloud_provider, self.clock, recorder=self.recorder, metrics=self.registry
        )
        self.np_state = NodePoolHealthState()
        self.lifecycle = LifecycleController(
            self.store, self.cluster, self.cloud_provider, self.clock,
            recorder=self.recorder, np_state=self.np_state, metrics=self.registry,
            registration_hooks=registration_hooks,
        )
        self.gc = GarbageCollectionController(self.store, self.cluster, self.cloud_provider, self.clock)
        self.binder = Binder(self.store, self.cluster, self.clock, dra_enabled=self.options.feature_gates.dynamic_resources)
        self.daemonset_runner = DaemonSetRunner(self.store, self.clock)
        self.termination = TerminationController(
            self.store, self.cluster, self.cloud_provider, self.clock,
            recorder=self.recorder, metrics=self.registry,
        )
        self.health = HealthController(
            self.store, self.cluster, self.cloud_provider, self.clock,
            recorder=self.recorder, metrics=self.registry,
            enabled=self.options.feature_gates.node_repair,
        )
        self.nodeclaim_disruption = NodeClaimDisruptionController(self.store, self.cluster, self.cloud_provider, self.clock)
        self.disruption = DisruptionController(
            self.store, self.cluster, self.provisioner, self.cloud_provider, self.clock, self.options,
            recorder=self.recorder, metrics=self.registry, cluster_cost=self.cluster_cost,
        )
        self.expiration = ExpirationController(self.store, self.clock, metrics=self.registry)
        self.consistency = ConsistencyController(self.store, self.clock, recorder=self.recorder)
        self.hydration = HydrationController(self.store)
        self.podevents = PodEventsController(self.store, self.clock)
        self.podevents.register()
        self.nodepool_hash = NodePoolHashController(self.store)
        self.nodepool_counter = NodePoolCounterController(self.store, self.cluster)
        self.nodepool_readiness = NodePoolReadinessController(self.store, self.clock)
        self.nodepool_registration_health = NodePoolRegistrationHealthController(self.store, self.np_state, self.clock)
        self.nodepool_validation = NodePoolValidationController(self.store, self.clock)
        self.pod_metrics = PodMetricsController(self.store, self.clock, self.registry)
        self.node_metrics = NodeMetricsController(self.store, self.cluster, self.clock, self.registry)
        self.nodepool_metrics = NodePoolMetricsController(self.store, self.registry, cluster_cost=self.cluster_cost)
        self.extra_controllers: list = []  # later controllers appended as built

        # pod and node watches trigger the provisioner batcher (the reference's
        # provisioning pod/node trigger controllers, state informer §3.5); the
        # node trigger also closes the gap between a headroom node registering
        # and the pass that records its buffer pods
        self.store.watch("Pod", lambda e, p: self.provisioner.trigger(p.metadata.uid) if e != "DELETED" else None)  # solverlint: ok(thread-escape): delegates straight to Batcher.trigger, whose state is lock-guarded; captures nothing mutable of its own
        self.store.watch("Node", lambda e, n: self.provisioner.trigger(n.metadata.uid) if e != "DELETED" else None)  # solverlint: ok(thread-escape): delegates straight to Batcher.trigger, whose state is lock-guarded; captures nothing mutable of its own

        # racecheck (obs/racecheck.py): under KARPENTER_SOLVER_RACECHECK=1
        # the instrumented locks publish their wait-time histogram to this
        # environment's registry (one env per operator process)
        from ..obs import racecheck

        if racecheck.racecheck_enabled():
            racecheck.set_metrics_registry(self.registry)

    def _make_solver(self, device=None):
        if self.options.solver_backend == "gpu":
            from ..solver.gpu import GPUSolver

            return GPUSolver(registry=self.registry, device=device)
        return FFDSolver()

    # -- deterministic driver --------------------------------------------------
    def tick(self, provision_force: bool = False, provision: bool = True) -> None:
        """One controller round: provision -> launch/register/init -> bind.
        `provision=False` skips the provisioner reconcile — fleet mode runs
        controller rounds on the operator thread while ALL solves stay on
        the fleet serve loop (one solver, one thread: the provisioner's
        encode caches and device-resident carry are single-threaded by
        design, the same contract ServingLoop relies on)."""
        if hasattr(self.cloud_provider, "flush_pending"):
            self.cloud_provider.flush_pending()
        self.nodeoverlay.reconcile()
        self.nodepool_hash.reconcile()
        self.nodepool_validation.reconcile()
        self.nodepool_registration_health.reconcile()
        self.nodepool_readiness.reconcile()
        if self.options.feature_gates.capacity_buffer:
            self.capacity_buffer.reconcile()
        self.static_provisioning.reconcile()
        self.static_deprovisioning.reconcile()
        if provision:
            self.provisioner.reconcile(force=provision_force)
        self.lifecycle.reconcile_all()
        if hasattr(self.cloud_provider, "flush_pending"):
            self.cloud_provider.flush_pending()
        self.lifecycle.reconcile_all()
        self.termination.reconcile()
        self.lifecycle.reconcile_all()  # claims whose node finished draining release
        self.gc.reconcile()
        if self.options.feature_gates.dynamic_resources:
            self.dra_kwok_driver.reconcile()
        # the DaemonSet controller stand-in materializes daemon pods on
        # registered nodes BEFORE the binder pass, so the binder's NodePorts
        # and resource checks see them like the real kube-scheduler would
        self.daemonset_runner.reconcile()
        self.binder.bind_all()
        if self.options.feature_gates.dynamic_resources:
            self.device_allocation.reconcile()
        self.nodepool_counter.reconcile()
        self.hydration.reconcile()
        self.consistency.reconcile()
        self.expiration.reconcile()
        self.health.reconcile()
        self.nodeclaim_disruption.reconcile()
        self.disruption.reconcile()
        self.pricing.reconcile()
        self.pod_metrics.reconcile()
        self.node_metrics.reconcile()
        self.nodepool_metrics.reconcile()
        from .. import metrics as m

        self.registry.gauge(m.CLUSTER_STATE_SYNCED).set(1.0 if self.cluster.synced() else 0.0)
        self.registry.gauge(m.CLUSTER_STATE_NODE_COUNT).set(len(self.cluster.nodes()))
        for c in self.extra_controllers:
            c.reconcile()

    def settle(self, rounds: int = 10, step_seconds: float = 2.0) -> None:
        """Advance time and tick until quiet (or rounds exhausted)."""
        for _ in range(rounds):
            if isinstance(self.clock, FakeClock):
                self.clock.step(step_seconds)
            self.tick(provision_force=True)

    # -- wall-clock operation (operator.Start + manager run loop) --------------
    def run(self, stop_event=None, tick_seconds: float = 1.0, leader_election: bool = True, identity: str = "") -> None:
        """The standby-capable run loop: informers are live from construction
        (controller warmup, operator.go:196-201); controller rounds execute
        only while holding the leader lease, which a background thread renews
        every retry_period so a long reconcile round can't starve the lease
        into a spurious takeover. Blocks until stop_event is set."""
        import uuid as _uuid

        from ..obs.racecheck import make_event, spawn_thread
        from .leaderelection import LeaderElector

        if isinstance(self.clock, FakeClock):
            raise ValueError("Environment.run drives wall-clock time; construct with clock=Clock() (FakeClock never advances here)")
        stop_event = stop_event or make_event()
        elector = None
        renewer = None
        if leader_election:
            elector = LeaderElector(self.store, self.clock, identity or f"karpenter-{_uuid.uuid4().hex[:8]}")
            renewer = spawn_thread(elector.renew_loop, name="karpenter-lease-renewer", args=(stop_event,))
        try:
            while not stop_event.is_set():
                if elector is None or elector.is_leader():
                    self.tick()
                stop_event.wait(tick_seconds)
        finally:
            # stop the renew thread BEFORE releasing: a live renewer would
            # immediately re-acquire the just-released lease (holder "" reads
            # as lapsed), blocking standby takeover while this process lingers
            stop_event.set()
            if elector is not None:
                if renewer is not None:
                    renewer.join(timeout=5)
                elector.release()
