"""FleetFrontend: push-driven wake + multi-tenant solver multiplexing.

The serving loop makes the solver a long-lived service, but alone its
arrival path's latency floor is the poll-based idle-window reconcile, and
one process serves exactly one cluster. This module is the horizontal-
scaling shape: ONE solver process multiplexing MANY tenant
clusters, with watch events flowing push-style into each tenant's Batcher
and on into the fleet loop.

Mechanisms, in dependency order:

- PUSH WAKE: every tenant Environment already routes store watch events
  into its provisioner's Batcher (`Provisioner.trigger`). The fleet
  completes the push path with two seams: the Batcher's `wake_hook` (fires
  on every trigger, after the batcher lock releases) and a per-tenant store
  watch callback (`TenantSession._on_watch_event`, so deletions — which
  never trigger the batcher — still wake promptly). Both mark the tenant
  RUNNABLE under the fleet lock and set the fleet's wake event; the serve
  loop sleeps on that event with a timeout of `min(batcher.eta())` over
  tenants with an open generation, so the idle/max batching window remains
  a COALESCING bound while the poll interval stops being a latency floor.
- FAIRNESS: one deficit-round-robin pass over the runnable tenants per
  `pump()` round. Each runnable tenant is credited `quantum` solve credits
  (banked deficit capped at `backlog_solve_cap`), and a solve costs one
  credit — a bursty tenant whose batcher re-arms after every solve (the
  coalesced-drain pattern) can run at most `backlog_solve_cap` solves per
  round before the ring moves on, so it cannot starve the rest.
- SHARED KERNEL SHAPES: the bucket high-water marks
  (models.scheduler_model._BUCKET_HW), the signature intern table and the
  row-artifact cache (solver.encode) are process-global, i.e. FLEET-scoped.
  Tenants share pack-kernel launch SHAPES — tenant N+1's first solve at
  the fleet's established marks records no kernel-library load — while actual
  tensor DATA stays per-tenant: row artifacts are keyed by each cluster's
  process-unique epoch and every EncodeCache/resident carry lives on the
  tenant's own solver. `isolation_audit()` verifies that discipline.
- PERSISTENT KERNEL BUILD: ``KARPENTER_SOLVER_COMPILE_CACHE=<dir>``
  (solver.gpu.configure_compile_cache) is the kernels' build directory, so
  a RESTARTED process or a fresh replica loads the built kernel library
  instead of running nvcc again — the cross-process arm of the warm-start
  story.

Every tenant's GPU solver runs on the fleet's `device` (None: the CUDA
device, which raises without CUDA; "cpu" runs the plain versions).

Determinism contract: `pump()` runs each tenant's ordinary
`ServingLoop.pump()` — the same reconcile the single-tenant poll loop runs
— so push-vs-poll and fleet-vs-solo placements are bit-identical for
identical event streams (tests pin this). The fleet changes WHEN solves
run, never what they compute.
"""

from __future__ import annotations

import time

from ..obs.racecheck import make_event, make_lock, spawn_thread, touch
from ..obs.trace import TraceRecorder
from .faults import TENANT_STATES, CircuitBreaker
from .loop import ServingLoop

# distinct tenant label values the bounded `tenant` metric label may carry
# before collapsing to "overflow" — kept under solverlint's
# max-label-values cap so the fleet can never become a cardinality leak
TENANT_LABEL_CAP = 12
_TENANT_LABELS: dict[str, str] = {}
# module-scoped (the label assignment is process-global like the caches it
# labels); constructed through the sanctioned factory
_TENANT_LABELS_LOCK = make_lock("fleet-labels")


def tenant_label(tenant_id: str) -> str:
    """The BOUNDED metric label for a tenant id: the first TENANT_LABEL_CAP
    distinct ids keep their sanitized form, later ones collapse to
    "overflow". Distinct ids NEVER share a label short of the cap — two ids
    whose sanitized forms collide ("team/a" vs "team:a") get a numeric
    disambiguator instead of silently merging their metric series. This is
    the `bounded_label_producers` entry solverlint's metric-label-
    cardinality rule trusts — every `tenant=` label value in the repo must
    come from here (or carry a justified pragma)."""
    tenant_id = str(tenant_id)
    with _TENANT_LABELS_LOCK:
        label = _TENANT_LABELS.get(tenant_id)
        if label is not None:
            return label
        if len(_TENANT_LABELS) >= TENANT_LABEL_CAP:
            label = "overflow"
        else:
            base = "".join(c if (c.isalnum() or c in "-_.") else "-" for c in tenant_id)[:60] or "default"
            # "overflow" is RESERVED for the past-the-cap bucket: an in-cap
            # tenant whose id sanitizes to it gets disambiguated instead of
            # merging its series with every capped tenant's
            used = set(_TENANT_LABELS.values()) | {"overflow"}
            label, n = base, 2
            while label in used:
                label, n = f"{base}-{n}", n + 1
        _TENANT_LABELS[tenant_id] = label
        return label


def reset_tenant_labels() -> None:
    """Drop the process-global label assignments (test isolation)."""
    with _TENANT_LABELS_LOCK:
        _TENANT_LABELS.clear()


# process-global fleet registry backing the operator's /debug/tenants
# surface (mirrors obs.podtrace's tenant-surface registry): FleetFrontend
# registers itself at construction and unregisters on close()
_FLEETS: list = []
_FLEETS_LOCK = make_lock("fleet-registry")


def _register_fleet(fleet: "FleetFrontend") -> None:
    with _FLEETS_LOCK:
        _FLEETS.append(fleet)


def _unregister_fleet(fleet: "FleetFrontend") -> None:
    with _FLEETS_LOCK:
        if fleet in _FLEETS:
            _FLEETS.remove(fleet)


def fleet_debug_surfaces() -> dict:
    """{tenant_id: breaker/backlog row} merged across every live fleet in
    this process — the /debug/tenants payload."""
    with _FLEETS_LOCK:
        fleets = list(_FLEETS)
    out: dict = {}
    for f in fleets:
        out.update(f.debug_tenants())
    return out


class TenantSession:
    """One tenant cluster resident in the fleet process: its own Store /
    Cluster / Provisioner / solver (own EncodeCache + device-resident carry,
    keyed per cluster the way `_row_cache_key` already keys rows) plus a
    private TraceRecorder so latency quantiles are per-tenant. Only kernel
    launch SHAPES are shared with other tenants, never tensors."""

    # racecheck guarded-field registry: wake stats are written from watch-
    # delivery threads (the wake_hook / _on_watch_event seams) and read by
    # the fleet loop and stats() callers
    GUARDED_FIELDS = {
        "wakes": "_lock",
        "last_wake_monotonic": "_lock",
    }

    def __init__(self, fleet: "FleetFrontend", tenant_id: str, env, loop: ServingLoop, recorder: TraceRecorder, label: str):
        self.fleet = fleet
        self.tenant_id = tenant_id
        self.label = label
        self.env = env
        self.loop = loop
        self.recorder = recorder
        self._lock = make_lock("fleet-session")
        self.wakes = 0  # wake SIGNALS delivered (watch + trigger seams; a
        # watch-driven trigger legitimately signals through both)
        self.last_wake_monotonic = 0.0

    # -- the push seams --------------------------------------------------------
    def _on_watch_event(self, event: str, obj) -> None:
        """Store watch -> fleet wake (runs on the committing thread under
        the store's delivery lock; registered in the thread-shared registry).
        Covers DELETED events, which never reach the batcher trigger."""
        self.on_trigger("watch-event")

    def _on_batcher_trigger(self) -> None:
        """The batcher's wake_hook seam (fires per trigger, after its lock
        releases) — the second push path, attributed separately so the wake
        split can tell trigger-driven wakes from raw watch deliveries."""
        self.on_trigger("batcher-window")

    def on_trigger(self, cause: str = "watch-event") -> None:
        """Push seam: record the signal and mark this tenant runnable with
        its bounded wake cause (obs.podtrace.WAKE_CAUSES). Cheap and
        leaf-locked by design — it runs on watch delivery threads."""
        with self._lock:
            touch(self, "wakes")
            self.wakes += 1
            self.last_wake_monotonic = time.monotonic()
        self.fleet._mark_runnable(self.tenant_id, cause)

    # -- fleet-facing surface --------------------------------------------------
    def ready(self) -> bool:
        return self.env.provisioner.batcher.ready()

    def pending(self) -> int:
        return self.env.provisioner.batcher.pending()

    def eta(self) -> float | None:
        return self.env.provisioner.batcher.eta()

    def wake_count(self) -> int:
        with self._lock:
            return self.wakes

    def close(self) -> None:
        self.env.provisioner.batcher.wake_hook = None
        self.env.store.unwatch("Pod", self._on_watch_event)
        self.env.store.unwatch("Node", self._on_watch_event)
        self.loop.close()


class FleetFrontend:
    """The multi-tenant serving front-end: tenant registry, push wake, and
    the deficit-round-robin scheduling loop."""

    # racecheck guarded-field registry: the tenant registry and runnable/
    # deficit state are written from watch-delivery threads (_mark_runnable)
    # and the fleet loop concurrently
    GUARDED_FIELDS = {
        "_sessions": "_lock",
        "_order": "_lock",
        "_runnable": "_lock",
        "_deficit": "_lock",
        "_runnable_since": "_lock",
        "_runnable_cause": "_lock",
        "_breakers": "_lock",
        "_shed_first": "_lock",
        "_age_labels": "_lock",
        "_thread": "_lock",
        "_stop": "_lock",
    }

    def __init__(
        self,
        registry=None,
        quantum: float | None = None,
        backlog_solve_cap: float = 4.0,
        poll_floor_seconds: float = 0.5,
        breaker_failures: int = 3,
        breaker_backoff_seconds: float = 0.5,
        breaker_backoff_max: float = 30.0,
        overload_backlog_cap: int | None = None,
        watchdog_age_seconds: float = 5.0,
        device=None,
    ):
        """`quantum`: solve credits added per runnable tenant per `pump()`
        round (deficit round-robin: a solve costs one credit, unspent credit
        banks across rounds, and the bank is capped at `backlog_solve_cap` —
        so a bursty tenant can never run more than the cap's worth of solves
        in one round, and a fractional quantum rate-limits a tenant across
        rounds). Default: the cap itself, so an uncontended tenant drains
        its whole coalesced backlog in one round. `poll_floor_seconds` is
        only the serve loop's LIVENESS backstop — arrivals wake it
        push-style, window closes wake it via `eta()`.

        Failure domains (faultline): each tenant gets a CircuitBreaker —
        `breaker_failures` consecutive pump exceptions QUARANTINE the tenant
        (the fleet keeps serving everyone else) and exponential-backoff
        half-open probes (`breaker_backoff_seconds`, doubling up to
        `breaker_backoff_max`) re-admit it.

        Overload protection: with `overload_backlog_cap` set, a tenant whose
        pending trigger backlog exceeds the cap has its batch generation
        SHED (its pending pods are served later — the tenant degrades
        itself, not the fleet), bounded by the oldest-event-age watchdog:
        once a shedding tenant's backlog ages past `watchdog_age_seconds`
        it is force-served. None (the default) disables shedding entirely.

        `device`: every tenant's GPU solver's (None: the CUDA device)."""
        from ..metrics import make_registry
        from ..solver.gpu import configure_compile_cache

        self.registry = registry if registry is not None else make_registry()
        self.device = device
        self.backlog_solve_cap = float(backlog_solve_cap)
        self.quantum = self.backlog_solve_cap if quantum is None else float(quantum)
        self.poll_floor = float(poll_floor_seconds)
        self.breaker_failures = int(breaker_failures)
        self.breaker_backoff_seconds = float(breaker_backoff_seconds)
        self.breaker_backoff_max = float(breaker_backoff_max)
        self.overload_backlog_cap = overload_backlog_cap
        self.watchdog_age = float(watchdog_age_seconds)
        self._lock = make_lock("fleet")
        self._wake = make_event()
        self._sessions: dict[str, TenantSession] = {}
        self._order: list[str] = []  # registration order = the DRR ring
        self._runnable: set[str] = set()
        self._deficit: dict[str, float] = {}
        self._runnable_since: dict[str, float] = {}
        # the bounded wake cause that OPENED each runnable episode — handed
        # to the tenant's podtrace at dispatch so per-event records carry it
        self._runnable_cause: dict[str, str] = {}
        # per-tenant circuit breakers (failure-domain isolation) and the
        # first-shed stamp the oldest-event-age watchdog bounds shedding by
        self._breakers: dict[str, CircuitBreaker] = {}
        self._shed_first: dict[str, float] = {}
        # tenant labels with a live oldest-age gauge series (zeroed on exit)
        self._age_labels: set = set()
        self._thread = None
        self._stop = make_event()
        self.pump_rounds = 0
        configure_compile_cache()
        _register_fleet(self)

    # -- tenant registry -------------------------------------------------------
    def add_tenant(
        self,
        tenant_id: str,
        options=None,
        instance_types=None,
        clock=None,
        env=None,
        double_buffer: bool | None = None,
        worker: bool = False,
        trace_capacity: int = 4096,
    ) -> TenantSession:
        """Build (or adopt, via `env`) a tenant control plane and wire it
        into the fleet: shared registry, per-tenant recorder, tenant-labeled
        solver, push-wake seams. The new tenant's first solve runs against
        the fleet's established kernel shapes — warm-start by construction."""
        from ..operator import Environment
        from ..operator.options import Options

        label = tenant_label(tenant_id)
        if env is None:
            env = Environment(
                options=options or Options(solver_backend="gpu"),
                clock=clock,
                instance_types=instance_types,
                registry=self.registry,
                device=self.device,
            )
        recorder = TraceRecorder(capacity=trace_capacity, enabled=True)
        if env.options.solver_backend == "gpu":
            from ..solver.gpu import GPUSolver

            env.provisioner.solver = GPUSolver(registry=self.registry, recorder=recorder, tenant=label,
                                               device=self.device)
        env.provisioner.tenant = label
        # relabel the environment's event tracer with the bounded fleet
        # label (it was built tenant="" before the session existed) and
        # register both per-tenant surfaces for ?tenant= debug routing
        tracer = getattr(env, "podtracer", None)
        if tracer is not None:
            tracer.tenant = label
            from ..obs.podtrace import register_tenant

            register_tenant(label, recorder, tracer)
        loop = ServingLoop(env.provisioner, env.store, double_buffer=double_buffer, worker=worker)
        sess = TenantSession(self, tenant_id, env, loop, recorder, label)
        # the failure-domain gate at the dispatch seam; deterministic
        # drivers get deterministic backoff through the tenant's own clock
        breaker = CircuitBreaker(
            failures_to_open=self.breaker_failures,
            backoff_seconds=self.breaker_backoff_seconds,
            backoff_max=self.breaker_backoff_max,
            now_fn=env.clock.now,
        )
        with self._lock:
            if tenant_id in self._sessions:
                raise ValueError(f"tenant {tenant_id!r} already registered")
            self._sessions[tenant_id] = sess
            self._order.append(tenant_id)
            self._deficit[tenant_id] = 0.0
            self._breakers[tenant_id] = breaker
        self._publish_tenant_state(sess, "healthy")
        # wire the push seams only after the session is registered, so a
        # wake racing registration can never reference an unknown tenant
        env.provisioner.batcher.wake_hook = sess._on_batcher_trigger
        env.store.watch("Pod", sess._on_watch_event)
        env.store.watch("Node", sess._on_watch_event)
        return sess

    def remove_tenant(self, tenant_id: str) -> None:
        with self._lock:
            sess = self._sessions.pop(tenant_id, None)
            if tenant_id in self._order:
                self._order.remove(tenant_id)
            self._runnable.discard(tenant_id)
            self._deficit.pop(tenant_id, None)
            self._runnable_since.pop(tenant_id, None)
            self._runnable_cause.pop(tenant_id, None)
            self._breakers.pop(tenant_id, None)
            self._shed_first.pop(tenant_id, None)
        if sess is not None:
            from .. import metrics as m
            from ..obs.podtrace import unregister_tenant

            # zero every state series for the departing tenant — a tenant
            # removed while quarantined (or mid-probe) must not report a
            # live breaker state forever (same stale-series hygiene as
            # _publish_oldest_ages)
            g = self.registry.gauge(m.SOLVER_TENANT_STATE)
            for s in TENANT_STATES:
                g.set(0.0, tenant=sess.label, state=s)  # solverlint: ok(metric-label-cardinality): tenant is a tenant_label() output fixed at registration; state iterates the static TENANT_STATES enum
            unregister_tenant(sess.label)
            sess.close()

    def sessions(self) -> dict[str, TenantSession]:
        with self._lock:
            return dict(self._sessions)

    def session(self, tenant_id: str) -> TenantSession | None:
        with self._lock:
            return self._sessions.get(tenant_id)

    # -- push wake -------------------------------------------------------------
    def _mark_runnable(self, tenant_id: str, cause: str = "rearm") -> int:
        """Mark a tenant runnable and wake the fleet loop. `cause` is the
        bounded wake attribution (obs.podtrace.WAKE_CAUSES) — only the FIRST
        signal of a runnable episode is attributed, so the split counts wake
        episodes, not raw triggers. Runs on watch-delivery threads: fleet
        lock only (leaf), metric emission outside."""
        with self._lock:
            sess = self._sessions.get(tenant_id)
            newly = sess is not None and tenant_id not in self._runnable
            if newly:
                self._runnable.add(tenant_id)
                self._runnable_since.setdefault(tenant_id, time.monotonic())
                self._runnable_cause.setdefault(tenant_id, cause)
            n_runnable = len(self._runnable)
        if newly:
            self._wake.set()
            from .. import metrics as m

            self.registry.counter(m.SOLVER_FLEET_WAKE_TOTAL).inc(tenant=sess.label, cause=cause)  # solverlint: ok(metric-label-cardinality): label is a tenant_label() output fixed at session registration and cause the static WAKE_CAUSES enum threaded from the wake seams
            self.registry.gauge(m.SOLVER_FLEET_RUNNABLE_TENANTS).set(n_runnable)
            tracer = getattr(sess.env, "podtracer", None)
            if tracer is not None:
                tracer.on_wake(cause)
        return 1 if newly else 0

    def runnable_tenants(self) -> list[str]:
        with self._lock:
            return [t for t in self._order if t in self._runnable]

    def rearm_ready(self, cause: str = "rearm") -> int:
        """Poll-fallback re-arm: mark every tenant whose batch window has
        closed (`ready()`) runnable, attributed to `cause` ("batcher-window"
        when the serve loop woke because the nearest eta elapsed,
        "poll-floor" on the liveness backstop, "rearm" for direct calls from
        deterministic drivers). A window that closed by TIME — no new event
        to push a wake — is still served through here."""
        n = 0
        for tid, sess in self.sessions().items():
            if sess.ready():
                self._mark_runnable(tid, cause)
                n += 1
        return n

    def next_eta(self) -> float | None:
        """Seconds until the nearest tenant batch window closes, or None
        when no tenant has an open generation. A quarantined tenant's eta is
        floored at its breaker's remaining backoff — its ready window cannot
        dispatch anyway, and returning its raw eta would hot-spin the serve
        loop against a tenant nothing will serve."""
        etas = []
        with self._lock:
            breakers = dict(self._breakers)
        for tid, s in self.sessions().items():
            e = s.eta()
            if e is None:
                continue
            breaker = breakers.get(tid)
            if breaker is not None:
                e = max(e, breaker.remaining_backoff())
            etas.append(e)
        return min(etas) if etas else None

    def rebalance(self, tenant_id: str, seed: int = 0) -> dict:
        """Opt-in global repack probe for ONE tenant (gated on the same
        KARPENTER_SOLVER_GLOBALPACK hatch as the disruption controller): ask
        the tenant's solver for a joint provisioning+retirement plan over
        its current consolidation candidates and pending pods, via
        `GPUSolver.global_repack_plan`. Returns the plan summary
        ({proposals, objective_improvement, rounded}) WITHOUT executing
        anything — the disruption controller owns exact validation and
        execution; this seam exists so fleet operators can see what a global
        solve would buy a tenant before enabling it there. Empty dict when
        the hatch is off, the tenant is unknown, or its solver lacks the
        tensor seam. Must run on the thread that owns the tenant's solver
        (the pump/operator thread) — same single-threaded solver contract as
        `pump`."""
        import os

        if os.environ.get("KARPENTER_SOLVER_GLOBALPACK", "0").strip().lower() not in ("1", "true", "on"):
            return {}
        sess = self.session(tenant_id)
        if sess is None:
            return {}
        env = sess.env
        solver = env.provisioner.solver
        if not hasattr(solver, "global_repack_plan"):
            return {}
        candidates = env.disruption.get_candidates()
        pending = env.provisioner.get_pending_pods()
        if len(candidates) < 2:
            return {"proposals": 0, "objective_improvement": 0.0, "rounded": 0}
        pools = {c.node_pool.metadata.name: c.node_pool for c in candidates}
        its = []
        for pool in pools.values():
            its.extend(env.provisioner.cloud_provider.get_instance_types(pool))
        subsets, info = solver.global_repack_plan(candidates, its, pending_pods=pending, seed=seed)
        return {"proposals": len(subsets), **info}

    # -- scheduling ------------------------------------------------------------
    def pump(self, force: bool = False, only: str | None = None) -> dict[str, int]:
        """One deficit-round-robin round over the runnable tenants; returns
        {tenant_id: solves run}. At round start every runnable tenant banks
        `quantum` solve credits (bank capped at `backlog_solve_cap`); each
        ring pass serves one solve per tenant with a whole credit, so a
        bursty tenant whose batcher re-arms after every solve (coalesced-
        drain churn) runs at most the cap's worth of solves per round —
        leftover backlog keeps it runnable for the next round — while a
        fractional-quantum tenant accrues across rounds. `force=True`
        treats the addressed tenants as runnable and forces their FIRST
        reconcile (deterministic drivers: harness base-fleet provisioning,
        bench warmup); `only` restricts the round to one tenant (the
        attached-harness drive path — avoids fanning a per-tenant warmup
        solve out across the whole fleet)."""
        self._rearm_overdue_shed()
        with self._lock:
            if force:
                self._runnable.update(self._sessions if only is None else [t for t in (only,) if t in self._sessions])
            ring = [t for t in self._order if t in self._runnable and (only is None or t == only)]
            for tid in ring:
                self._deficit[tid] = min(self._deficit.get(tid, 0.0) + self.quantum, self.backlog_solve_cap)
        self._publish_oldest_ages(ring)
        served: dict[str, int] = {}
        progress = True
        while progress:
            progress = False
            for tid in ring:
                with self._lock:
                    sess = self._sessions.get(tid)
                    active = sess is not None and tid in self._runnable
                    credit = self._deficit.get(tid, 0.0)
                    breaker = self._breakers.get(tid)
                if not active or credit < 1.0:
                    # out-of-credit tenants STAY runnable — the next round
                    # (or the serve loop's next wake) continues them
                    continue
                # force applies to the FIRST solve per tenant only: later
                # solves in the round are the batcher's own coalesced drain,
                # exactly like ServingLoop.pump + drain on the poll path
                eff_force = force and served.get(tid, 0) == 0
                if not (eff_force or sess.ready()):
                    self._retire(tid)
                    continue
                if breaker is not None and not breaker.allow():
                    # QUARANTINED failure domain: the tenant stays registered
                    # and runnable, but nothing dispatches until the backoff
                    # elapses and a half-open probe re-admits it — the ring
                    # moves on and healthy tenants keep being served
                    continue
                probing = breaker is not None and breaker.state_name() == "probing"
                if probing:
                    self._note_transition(sess, "probing")
                    # the gauge must show the half-open window too — a probe
                    # solve can run for seconds (e.g. a full-reencode
                    # recovery) and /metrics reporting `quarantined` for its
                    # whole duration would contradict the TENANT_STATES enum
                    self._publish_tenant_state(sess, "probing")
                # forced pumps are deterministic-driver overrides (harness
                # provisioning, bench warmup) — they bypass load shedding
                if not eff_force and self._should_shed(tid, sess):
                    if probing:
                        # the admitted probe was SHED, not dispatched:
                        # resolve it as inconclusive (re-quarantine without
                        # doubling) — otherwise the breaker wedges in
                        # `probing` (allow() admits exactly one probe per
                        # window) and the tenant can never dispatch again
                        breaker.probe_inconclusive()
                        self._publish_tenant_state(sess, breaker.state_name())
                    continue
                self._observe_sched_wait(tid, sess)
                try:
                    results = sess.loop.pump(force=eff_force)
                except Exception as e:  # solverlint: ok(swallowed-exception): the failure-domain seam — _on_tenant_failure records it on the breaker, the transitions counter, and the tenant-state gauge
                    self._on_tenant_failure(tid, sess, breaker, e)
                    with self._lock:
                        self._deficit[tid] = self._deficit.get(tid, 0.0) - 1.0
                    if not sess.ready():
                        self._retire(tid)
                    continue
                with self._lock:
                    # a declined reconcile (e.g. cluster mid-sync) still
                    # costs the credit, so a stuck tenant cannot pin the loop
                    self._deficit[tid] = self._deficit.get(tid, 0.0) - 1.0
                if results is not None:
                    served[tid] = served.get(tid, 0) + 1
                    progress = True
                    self._on_tenant_success(tid, sess, breaker)
                elif probing:
                    # the probe never produced a verdict — re-quarantine
                    # without doubling so the next window probes again
                    breaker.probe_inconclusive()
                    self._publish_tenant_state(sess, breaker.state_name())
                if not sess.ready():
                    self._retire(tid)
        self.pump_rounds += 1
        self._publish_runnable()
        return served

    # -- failure domains + overload protection (faultline) ---------------------
    def _on_tenant_failure(self, tenant_id: str, sess: TenantSession, breaker: CircuitBreaker | None, err: BaseException) -> None:
        """A tenant pump RAISED past the solver's own degradation ladder:
        record it on the tenant's breaker and publish the state — the
        exception is contained here, the fleet loop never dies."""
        if breaker is None:
            return
        opened = breaker.record_failure(err)
        if opened is not None:
            self._note_transition(sess, "quarantined")
        self._publish_tenant_state(sess, breaker.state_name())

    def _on_tenant_success(self, tenant_id: str, sess: TenantSession, breaker: CircuitBreaker | None) -> None:
        with self._lock:
            self._shed_first.pop(tenant_id, None)
        if breaker is None:
            return
        if breaker.record_success():
            self._note_transition(sess, "healthy")
            self._publish_tenant_state(sess, "healthy")

    def _note_transition(self, sess: TenantSession, state: str) -> None:
        from .. import metrics as m

        self.registry.counter(m.SOLVER_BREAKER_TRANSITIONS_TOTAL).inc(tenant=sess.label, state=state)  # solverlint: ok(metric-label-cardinality): tenant is a tenant_label() output fixed at registration; state literals at every call site come from the static TENANT_STATES enum

    def _publish_tenant_state(self, sess: TenantSession, state: str) -> None:
        from .. import metrics as m

        g = self.registry.gauge(m.SOLVER_TENANT_STATE)
        for s in TENANT_STATES:
            g.set(1.0 if s == state else 0.0, tenant=sess.label, state=s)  # solverlint: ok(metric-label-cardinality): tenant is a tenant_label() output fixed at registration; state iterates the static TENANT_STATES enum

    def _should_shed(self, tenant_id: str, sess: TenantSession) -> bool:
        """Per-tenant overload protection: when the tenant's pending trigger
        backlog exceeds the cap, SHED its batch generation (the triggers are
        dropped; the pods stay pending in the store and are served by a
        later, larger window) instead of solving — the overloaded tenant
        degrades its own latency, not the fleet's. Shedding is bounded by
        the oldest-event-age watchdog: once the tenant has been shedding
        for `watchdog_age` seconds it is force-served."""
        cap = self.overload_backlog_cap
        if not cap:
            return False
        pending = sess.pending()
        if pending <= cap:
            with self._lock:
                self._shed_first.pop(tenant_id, None)
            return False
        from .. import metrics as m

        # the tenant's OWN clock, same as its breaker's backoff: shedding
        # stays deterministic under a fake-clock driver and a slow CI
        # machine cannot trip the watchdog mid-test on wall time
        now = sess.env.clock.now()
        with self._lock:
            first = self._shed_first.setdefault(tenant_id, now)
        if now - first >= self.watchdog_age:
            # the watchdog bound: serve now, open the next shed window
            self.registry.counter(m.SOLVER_FLEET_WATCHDOG_TOTAL).inc(tenant=sess.label)  # solverlint: ok(metric-label-cardinality): tenant is a tenant_label() output fixed at session registration — the bounded fleet enum
            with self._lock:
                self._shed_first[tenant_id] = now
            return False
        sess.env.provisioner.batcher.reset()
        self.registry.counter(m.SOLVER_FLEET_SHED_TOTAL).inc(pending, tenant=sess.label)  # solverlint: ok(metric-label-cardinality): tenant is a tenant_label() output fixed at session registration — the bounded fleet enum
        self._retire(tenant_id)
        return True

    def _rearm_overdue_shed(self) -> None:
        """The watchdog's out-of-band half: a shed dropped the tenant's
        batch generation, so if arrivals then STOP nothing would ever
        re-open its window and the shed backlog (pods still pending in the
        store) would strand forever. For every shed-stamped tenant whose
        stamp aged past the watchdog bound with no window pending, fire one
        batcher trigger — the stranded pods are served by the normal window
        one idle-duration later. The stamp advances to now, so the re-arm
        fires at most once per watchdog period."""
        from .. import metrics as m

        with self._lock:
            stamped = [(t, self._sessions[t], f) for t, f in self._shed_first.items() if t in self._sessions]
        for tid, sess, first in stamped:
            now = sess.env.clock.now()
            if now - first < self.watchdog_age or sess.pending():
                continue
            with self._lock:
                self._shed_first[tid] = now
            self.registry.counter(m.SOLVER_FLEET_WATCHDOG_TOTAL).inc(tenant=sess.label)  # solverlint: ok(metric-label-cardinality): tenant is a tenant_label() output fixed at session registration — the bounded fleet enum
            sess.env.provisioner.trigger("shed-watchdog")

    def _publish_oldest_ages(self, ring: list) -> None:
        from .. import metrics as m

        now = time.monotonic()
        with self._lock:
            ages = {
                self._sessions[t].label: now - self._runnable_since.get(t, now)
                for t in ring
                if t in self._sessions
            }
            # zero the series of tenants that LEFT the ring: a drained
            # tenant's gauge must not freeze at its last nonzero age
            stale = self._age_labels - set(ages)
            self._age_labels = set(ages)
        g = self.registry.gauge(m.SOLVER_FLEET_OLDEST_EVENT_AGE)
        for label in sorted(stale):
            g.set(0.0, tenant=label)  # solverlint: ok(metric-label-cardinality): label is a tenant_label() output recorded at session registration — the capped fleet enum
        for label, age in ages.items():
            g.set(age, tenant=label)  # solverlint: ok(metric-label-cardinality): label is a tenant_label() output recorded at session registration — the capped fleet enum

    def debug_tenants(self) -> dict:
        """The /debug/tenants rows: per-tenant breaker state, backlog, and
        wake stats — the observable half of failure-domain isolation."""
        out: dict = {}
        for tid, sess in self.sessions().items():
            with self._lock:
                breaker = self._breakers.get(tid)
                runnable = tid in self._runnable
            row = {
                "label": sess.label,
                "runnable": runnable,
                "pending_triggers": sess.pending(),
                "wakes": sess.wake_count(),
            }
            if breaker is not None:
                row.update(breaker.snapshot())
            out[tid] = row
        return out

    def _retire(self, tenant_id: str) -> None:
        """The tenant's window is no longer ready: drop it from the runnable
        set and zero its banked deficit (DRR resets credit on empty)."""
        with self._lock:
            self._runnable.discard(tenant_id)
            self._deficit[tenant_id] = 0.0
            self._runnable_since.pop(tenant_id, None)
            self._runnable_cause.pop(tenant_id, None)

    def _observe_sched_wait(self, tenant_id: str, sess: TenantSession) -> None:
        with self._lock:
            since = self._runnable_since.pop(tenant_id, None)
            cause = self._runnable_cause.pop(tenant_id, "")
            credit = self._deficit.get(tenant_id, 0.0)
        if since is not None:
            wait = time.monotonic() - since
            from .. import metrics as m

            self.registry.histogram(m.SOLVER_FLEET_SCHED_WAIT_SECONDS).observe(
                wait, tenant=sess.label  # solverlint: ok(metric-label-cardinality): label is a tenant_label() output fixed at session registration — the bounded fleet enum
            )
            # hand the DRR wait (plus round + banked credit + the episode's
            # wake cause at dispatch) to the tenant's event tracer: the next
            # dispatch's events carry them on their records
            tracer = getattr(sess.env, "podtracer", None)
            if tracer is not None:
                tracer.note_sched_wait(wait, drr_round=self.pump_rounds, credit=credit, cause=cause)

    def _publish_runnable(self) -> None:
        with self._lock:
            n_runnable = len(self._runnable)
        from .. import metrics as m

        self.registry.gauge(m.SOLVER_FLEET_RUNNABLE_TENANTS).set(n_runnable)

    # -- the wall-clock serve loop --------------------------------------------
    def start(self) -> None:
        """Spawn the fleet serve loop (wall-clock deployments; deterministic
        drivers call `pump()` directly instead)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop = make_event()
            self._thread = spawn_thread(self._serve_loop, name="karpenter-fleet", args=(self._stop,))

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
            stop = self._stop
        stop.set()
        self._wake.set()
        if t is not None:
            t.join(timeout=5)

    def serving(self) -> bool:
        with self._lock:
            return self._thread is not None

    def _serve_loop(self, stop) -> None:
        """Push-driven: sleep on the wake event until an arrival wakes us or
        the nearest batch window closes; then re-arm time-ready tenants and
        run one DRR round. The poll floor is only a liveness backstop."""
        while not stop.is_set():
            timeout = self.poll_floor
            eta = self.next_eta()
            if eta is not None:
                timeout = min(timeout, eta)
            if timeout > 0:
                self._wake.wait(timeout=timeout)
            self._wake.clear()
            if stop.is_set():
                return
            # wake attribution: push wakes attributed themselves at the
            # trigger seams; any tenant rearm_ready marks here is one whose
            # window closed by TIME — "batcher-window" whenever a window was
            # open (incl. timeout<=0 and push-coincident sweeps), the
            # "poll-floor" liveness backstop otherwise. The "rearm" cause
            # stays reserved for deterministic drivers calling rearm_ready
            # directly.
            self.rearm_ready("batcher-window" if eta is not None else "poll-floor")
            served = self.pump()
            if not served and (eta := self.next_eta()) is not None and eta <= 0:
                # a window is ready but its reconcile declined to solve —
                # e.g. the cluster is mid-registration and unsynced while
                # the tick thread catches up. eta()==0 would make the wait
                # above a no-op, so back off briefly instead of hot-spinning
                # against the very thread that clears the condition.
                self._wake.wait(timeout=0.005)

    def close(self) -> None:
        self.stop()
        for tid in list(self.sessions()):
            self.remove_tenant(tid)
        _unregister_fleet(self)

    # -- observability ---------------------------------------------------------
    def stats(self) -> dict:
        """Per-tenant serving stats from each session's private recorder
        (solves by mode, rolling quantiles, wakes, backlog)."""
        out: dict = {}
        for tid, sess in self.sessions().items():
            traces = [t for t in sess.recorder.traces() if t.mode not in ("", "consolidate")]
            modes: dict[str, int] = {}
            for t in traces:
                modes[t.mode] = modes.get(t.mode, 0) + 1
            out[tid] = {
                "label": sess.label,
                "solves": len(traces),
                "modes": modes,
                "quantiles": sess.recorder.stats(),
                "wakes": sess.wake_count(),
                "pending_triggers": sess.pending(),
            }
        return out

    def isolation_audit(self) -> dict:
        """Audit the fleet-scoped (process-global) solver caches for cross-
        tenant isolation: SHAPES and content-addressed pod-shape tuples are
        shared by design; row TENSORS must be keyed by a process-unique
        cluster epoch. Raises AssertionError when a registered tenant's
        cluster epoch collides with another's, or when a row-cache key does
        not lead with an epoch token — either would make one tenant's
        tensors reachable from another's lookups."""
        from ..models.scheduler_model import bucket_highwater
        from ..solver.encode import encode_shared_stats

        shared = encode_shared_stats()
        epochs: dict[int, str] = {}
        for tid, sess in self.sessions().items():
            epoch = getattr(sess.env.cluster, "epoch", None)
            assert epoch is not None, f"tenant {tid!r}: cluster has no epoch token — row-cache keys would be id()-recyclable"
            assert epoch not in epochs, f"tenants {epochs[epoch]!r} and {tid!r} share cluster epoch {epoch} — row artifacts would alias"
            epochs[epoch] = tid
        for e in shared["row_global_epochs"]:
            assert isinstance(e, int), f"row-cache key epoch {e!r} is not a process-unique token"
        return {
            "shared_shapes": bucket_highwater(),
            "shared_sig_intern": shared["sig_intern"],
            "row_artifacts": shared["row_global"],
            "tenant_epochs": {tid: e for e, tid in epochs.items()},
            "tenant_row_artifacts": {
                epochs[e]: n for e, n in shared["row_global_by_epoch"].items() if e in epochs
            },
        }
