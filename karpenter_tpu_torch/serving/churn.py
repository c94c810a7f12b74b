"""ChurnHarness: sustained pod churn against a live Provisioner+GPUSolver.

The harness's solver runs on `device` (None: the CUDA device, which raises
without CUDA; "cpu" runs the kernels' plain versions). The recompile columns
read the solve trace's sentinel, which in the port counts builds and loads of
the kernel library (`kernels.build.LOADS`).

The harness builds a real control plane (operator.Environment: store,
informers, KWOK cloud provider, lifecycle, binder), provisions a base fleet,
then drives a steady arrival/cancel/departure mix through the ServingLoop
for many solve cycles, measuring the serving regime every earlier bench
skipped:

- throughput: pod churn events applied per wall-clock second;
- re-solve latency: P50/P99 over every steady-phase SolveTrace duration
  (the solvetrace ring is the source of truth — the same quantile machinery
  /debug/solves publishes);
- delta-hit rate: the share of solves served from device-resident state
  (mode "delta"/"hybrid-delta") vs full re-encodes — the number that shows
  whether the clone-identity prestager + node_generation row key actually
  let the encoder recognize consecutive serving snapshots;
- recompiles: the solvetrace sentinel's per-fn counts over the steady phase.
  After warmup (which pays every cold compile at the high-water shapes) the
  steady phase must record ZERO — the KARPENTER_SOLVER_BUCKET high-water
  ladder is what pins the kernels' launch shapes under churn.

The event mix is deliberately shaped like a serving steady state: arrivals
land on capacity freed by departures (claims are only created when the mix
overshoots — creating one bumps node_generation and honestly costs a full
re-encode), cancellations delete still-pending pods (the pure pod-axis
removal delta), and bound-pod departures batch onto the periodic bind-flush
iterations that already pay a row-side re-encode.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field

from .. import metrics as m
from ..obs.stats import quantile
from ..obs.trace import TraceRecorder
from .loop import ServingLoop


@dataclass
class ChurnSpec:
    # fleet / catalog scale (defaults = the 1/10-scale CPU gate)
    n_base_pods: int = 5000
    n_types: int = 100
    # steady-phase event mix, per iteration. The defaults BALANCE: per cycle
    # (bind_every iterations) net arrivals == departures, so the bound fleet
    # and node count stay constant — growth is a real workload change and
    # legitimately pays a (one-time, high-water) compile, but steady state
    # must not.
    arrivals: int = 800
    cancels: int = 600
    departures: int = 800  # applied on bind-flush iterations only
    # share of cancellations that hit the NEWEST pending pods (users
    # cancelling just-submitted work). Those typically arrive and cancel
    # within one batching window, so the coalesced solve never sees them —
    # the serving loop absorbs both events for free. The remainder cancels
    # the OLDEST pending pods, i.e. already-placed ones, exercising the
    # removal re-credit delta in steady state.
    cancel_newest_frac: float = 0.8
    bind_every: int = 4  # every k-th iteration flushes lifecycle+binder
    iterations: int = 40
    warmup_cycles: int = 3  # full bind_every-cycles before the sentinel mark
    batch_idle_seconds: float = 0.25
    # wall-clock seconds of the post-steady CONCURRENT segment: a driver
    # thread applies events while the loop solves, so triggers land mid-solve
    # and the batcher's in-flight coalescing (N triggers -> one follow-up
    # solve) is demonstrated, not just unit-tested. 0 skips the segment.
    concurrent_seconds: float = 1.5
    seed: int = 0
    # record/replay (the ROADMAP trace-replay seed): `record_path` dumps the
    # applied event stream as JSONL (one op per line: arrive/cancel/depart/
    # solve/bind_flush/mark — self-contained pod params plus `t`, the op's
    # wall offset from recording start, so a replay's podtrace latency
    # measurements can be compared against the recorded pacing; replayable
    # without the generator); `replay_events` drives the harness from a log
    # instead of generating events, deterministically — the multi-tenant
    # bench replays ONE recorded log into K fleet tenants. Record with
    # concurrent_seconds=0: the concurrent segment's thread interleaving is
    # inherently non-replayable and is logged only in arrival order.
    record_path: str | None = None
    replay_events: list | None = None
    # faultline (serving/faults.py): a seeded FaultSpec plan installed at the
    # named seams (solver hook, store watch delivery, prestager worker,
    # cycle-boundary revocations). None = no injector, zero-cost seams. The
    # spec rides the recorded JSONL header; revocations ride the log as
    # explicit `revoke` ops, so a replay applies them verbatim instead of
    # re-consuming the plan (run_replay never calls take_revocations).
    faults: object | None = None
    double_buffer: bool | None = None  # None = env default (on)
    # worker=False: prestage synchronously. On a CPU-only harness the pack
    # "device" shares the host cores, so a prestage thread can only contend
    # (GIL) — the double buffer's wins here are clone identity + staged-at-
    # event-time prep. On the card the pack landing blocks on the device and
    # the worker overlaps for free; set worker=True there.
    worker: bool = False
    trace_capacity: int = 8192

    @classmethod
    def from_event_log(cls, path: str, tenant=None, **overrides) -> "ChurnSpec":
        """A replay spec: drive the harness from a recorded JSONL event log
        instead of generating events. Scale fields are taken from the log's
        header line when present (so gates scale consistently); overrides
        win. The replay is deterministic: same log + same seed = the same
        placements, which is what lets one recorded stream drive K fleet
        tenants and be compared bit-for-bit.

        `tenant` (a tenant id or a collection of them) replays a NAMED
        SUBSET of a tenant-stamped log: ops whose `tenant` tag names a
        different tenant are dropped, while untagged ops (single-tenant
        recordings, shared pacing skeleton) always replay. This is the
        shard re-homing contract — "replay only tenant-7's ops" into a
        surviving shard after its home shard dies."""
        tenants = None
        if tenant is not None:
            tenants = {tenant} if isinstance(tenant, str) else set(tenant)
        events = []
        header: dict = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                op = json.loads(line)
                if op.get("op") == "header":
                    header = op
                elif tenants is None or op.get("tenant") is None or op["tenant"] in tenants:
                    events.append(op)
        kw = {k: header[k] for k in ("n_base_pods", "n_types", "arrivals", "cancels", "departures", "bind_every", "seed", "batch_idle_seconds") if k in header}
        if header.get("faults"):
            from .faults import FaultSpec

            # the recorded fault plan re-installs at the same seams; its
            # solve/watch indices replay against the same op stream, and
            # revocations apply from the logged `revoke` ops (never from the
            # plan — run_replay bypasses take_revocations)
            kw["faults"] = FaultSpec.from_dict(header["faults"])
        kw.update(overrides)
        kw["replay_events"] = events
        kw.setdefault("concurrent_seconds", 0.0)
        return cls(**kw)


@dataclass
class ChurnReport:
    events: int = 0
    wall_seconds: float = 0.0
    events_per_sec: float = 0.0
    solves: int = 0
    modes: dict = field(default_factory=dict)
    delta_hit_rate: float = 0.0
    p50_solve_seconds: float = 0.0
    p99_solve_seconds: float = 0.0
    recompiles: dict = field(default_factory=dict)
    steady_recompiles: int = 0
    # steady-phase full-solve share broken down by delta-reject reason (the
    # karpenter_solver_delta_reject_total counter, windowed over the steady
    # mark) — so a delta-hit regression names the reject family that caused
    # it instead of a bare hit-rate drop
    full_solve_reasons: dict = field(default_factory=dict)
    coalesced_triggers: int = 0
    concurrent_events: int = 0
    concurrent_solves: int = 0
    pods_per_solve_p50: float = 0.0
    prestage_reused: int = 0
    prestage_staged: int = 0
    n_nodes: int = 0
    n_pending_end: int = 0
    # podtrace (obs/podtrace.py) end-to-end columns over the steady window:
    # event-to-PLACEMENT latency per completed EventRecord, with the
    # per-stage decomposition and the stage that dominated the e2e mean —
    # the number a USER of the cluster experiences, vs p50/p99_solve_seconds
    # which only time the re-solve itself
    e2e_events: int = 0
    e2e_p50_seconds: float = 0.0
    e2e_p99_seconds: float = 0.0
    dominant_stage: str = ""
    stage_p99_seconds: dict = field(default_factory=dict)
    slo_breaches: int = 0
    # faultline columns: what the FaultSpec injected over the whole run, the
    # recovery-ladder steps the solver took over the steady window, nodes
    # revoked, and prestager worker restarts — so a chaos run's report shows
    # both the disruption applied AND the machinery that absorbed it
    faults_injected: dict = field(default_factory=dict)
    recoveries: dict = field(default_factory=dict)
    revoked_nodes: int = 0
    prestage_worker_restarts: int = 0

    def as_dict(self) -> dict:
        return {
            "events": self.events,
            "wall_seconds": round(self.wall_seconds, 3),
            "events_per_sec": round(self.events_per_sec, 1),
            "solves": self.solves,
            "modes": dict(self.modes),
            "delta_hit_rate": round(self.delta_hit_rate, 4),
            "p50_solve_seconds": round(self.p50_solve_seconds, 4),
            "p99_solve_seconds": round(self.p99_solve_seconds, 4),
            "e2e_events": self.e2e_events,
            "e2e_p50_seconds": round(self.e2e_p50_seconds, 4),
            "e2e_p99_seconds": round(self.e2e_p99_seconds, 4),
            "dominant_stage": self.dominant_stage,
            "stage_p99_seconds": {k: round(v, 4) for k, v in self.stage_p99_seconds.items()},
            "slo_breaches": self.slo_breaches,
            "recompiles": dict(self.recompiles),
            "steady_recompiles": self.steady_recompiles,
            "full_solve_reasons": dict(self.full_solve_reasons),
            "coalesced_triggers": self.coalesced_triggers,
            "concurrent_events": self.concurrent_events,
            "concurrent_solves": self.concurrent_solves,
            "pods_per_solve_p50": round(self.pods_per_solve_p50, 1),
            "prestage_reused": self.prestage_reused,
            "prestage_staged": self.prestage_staged,
            "n_nodes": self.n_nodes,
            "n_pending_end": self.n_pending_end,
            "faults_injected": dict(self.faults_injected),
            "recoveries": dict(self.recoveries),
            "revoked_nodes": self.revoked_nodes,
            "prestage_worker_restarts": self.prestage_worker_restarts,
        }


# a fixed shape alphabet: churn arrivals cycle deployment-replica shapes, so
# first contacts batch-stamp and every later encode reads stamps (the
# signature axis stays inside its high-water bucket)
_SHAPES = [
    ("250m", "512Mi", None, None),
    ("500m", "512Mi", None, None),
    ("500m", "1Gi", None, None),
    ("1", "1Gi", None, None),
    ("1", "2Gi", None, None),
    ("2", "2Gi", None, None),
    ("250m", "1Gi", {"tier": "web"}, None),
    ("500m", "2Gi", {"tier": "batch"}, None),
    ("1", "512Mi", None, "test-zone-a"),
    ("500m", "1Gi", None, "test-zone-b"),
]


def _make_pod(name: str, cpu: str, memory: str, labels=None, zone: str | None = None):
    from ..apis import labels as wk
    from ..kube.objects import Container, ObjectMeta, Pod, PodSpec
    from ..utils.resources import parse_resource_list

    sel = {wk.ZONE_LABEL_KEY: zone} if zone else {}
    return Pod(
        # deterministic uid: pods created in one fake-clock instant tie-break
        # FFD order on uid, and the parity tests compare two independently
        # built environments — random uids would make even two serial runs
        # disagree on placement grouping
        metadata=ObjectMeta(name=name, namespace="default", uid=f"uid-{name}", labels=dict(labels or {})),
        spec=PodSpec(
            containers=[Container(resources={"requests": parse_resource_list({"cpu": cpu, "memory": memory})})],
            node_selector=sel,
        ),
    )


class ChurnHarness:
    def __init__(self, spec: ChurnSpec | None = None, device=None):
        """`device`: the GPU solver's (None: the CUDA device); an attached
        harness runs on its session's solver instead."""
        self.spec = spec or ChurnSpec()
        self.device = device
        self._seq = 0
        self._pending: deque[str] = deque()  # created, not yet observed bound
        self._bound: deque[str] = deque()
        self._prebuilt: deque = deque()  # pre-constructed arrival pods
        self.env = None
        self.loop: ServingLoop | None = None
        # fleet mode (attach): solves route through the FleetFrontend's DRR
        # pump instead of the private ServingLoop, scoped to this tenant
        self.fleet = None
        self._tenant_id = None
        # faultline: the live FaultInjector when spec.faults is set (installed
        # by _install_faults from build()/attach())
        self.injector = None
        self.recorder = TraceRecorder(capacity=self.spec.trace_capacity, enabled=True)
        # record/replay: the applied-event log (None = not recording). Every
        # op carries `t`, its wall-clock offset from recording start — the
        # per-event arrival timing that lets a replayed log's latency
        # measurements be compared against the recorded run's pacing.
        self._event_log: list[dict] | None = [] if self.spec.record_path else None
        self._log_t0 = time.perf_counter()

    def _log(self, **op) -> None:
        if self._event_log is not None:
            op.setdefault("t", round(time.perf_counter() - self._log_t0, 6))
            # fleet-attached recordings stamp every op with the owning tenant
            # so a merged/fleet log can later be replayed for a NAMED subset
            # (from_event_log(tenant=...)) — the shard re-homing contract
            if self._tenant_id is not None:
                op.setdefault("tenant", self._tenant_id)
            self._event_log.append(op)

    # -- stack -----------------------------------------------------------------
    def build(self):
        import random

        from ..apis import labels as wk
        from ..apis.nodepool import NodePool
        from ..cloudprovider.fake import instance_types_assorted
        from ..kube.objects import ObjectMeta
        from ..operator import Environment
        from ..operator.options import Options
        from ..solver.gpu import GPUSolver

        # claim-name suffixes come from the global RNG; node iteration order
        # sorts on them — seed so two runs of the same spec agree
        random.seed(self.spec.seed)

        env = Environment(
            options=Options(
                solver_backend="gpu",
                batch_idle_duration=self.spec.batch_idle_seconds,
                batch_max_duration=10.0,
            ),
            instance_types=instance_types_assorted(self.spec.n_types),
            device=self.device,
        )
        pool = NodePool(metadata=ObjectMeta(name="churn-pool"))
        pool.spec.template.requirements = [
            {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
            {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
        ]
        env.store.create(pool)
        # a private flight recorder: the harness wants the WHOLE run's traces
        # (the process-default ring is 256) without perturbing other solvers
        env.provisioner.solver = GPUSolver(registry=env.registry, recorder=self.recorder, device=self.device)
        self.env = env
        self.loop = ServingLoop(
            env.provisioner,
            env.store,
            double_buffer=self.spec.double_buffer,
            worker=self.spec.worker,
        )
        self._install_faults()
        return self

    def attach(self, session, fleet=None):
        """Attach to a fleet TenantSession instead of building a private
        stack: the session's env/loop/recorder serve this harness, and with
        `fleet` given, `solve()` routes through the fleet's DRR pump (the
        push-wake path) instead of pumping the tenant loop directly. The
        caller owns batch-window sizing via the session's Options."""
        import random

        from ..apis import labels as wk
        from ..apis.nodepool import NodePool
        from ..kube.objects import ObjectMeta

        random.seed(self.spec.seed)
        self.env = session.env
        self.loop = session.loop
        self.recorder = session.recorder
        self.fleet = fleet
        self._tenant_id = session.tenant_id
        if self.env.store.try_get("NodePool", "churn-pool") is None:
            pool = NodePool(metadata=ObjectMeta(name="churn-pool"))
            pool.spec.template.requirements = [
                {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
                {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
            ]
            self.env.store.create(pool)
        self._install_faults()
        return self

    def close(self) -> None:
        if self.loop is not None:
            self.loop.close()

    def _install_faults(self) -> None:
        """Install the spec's FaultInjector at every named seam this stack
        exposes: the solver's solve/re-encode hook, the store's watch
        delivery, and the prestager worker loop. Revocations are pulled at
        cycle boundaries by run_cycle."""
        if self.spec.faults is None:
            return
        from .faults import FaultInjector

        self.injector = FaultInjector(self.spec.faults, registry=self.env.registry)
        solver = self.env.provisioner.solver
        if hasattr(solver, "fault_hook"):
            solver.fault_hook = self.injector.solver_hook
        self.env.store.set_fault_injector(self.injector)
        if self.loop is not None and self.loop.prestager is not None:
            self.loop.prestager.fault_hook = self.injector.prestage_hook

    # -- event application -----------------------------------------------------
    def _record_events(self, n: int, event: str) -> None:
        if n and self.env is not None:
            tenant = self.env.provisioner.tenant
            if event == "arrival":
                self.env.registry.counter(m.SOLVER_CHURN_EVENTS_TOTAL).inc(n, event="arrival", tenant=tenant)  # solverlint: ok(metric-label-cardinality): tenant is the provisioner's fleet registration label (a tenant_label() output; "" outside a fleet)
            else:
                self.env.registry.counter(m.SOLVER_CHURN_EVENTS_TOTAL).inc(n, event="departure", tenant=tenant)  # solverlint: ok(metric-label-cardinality): tenant is the provisioner's fleet registration label (a tenant_label() output; "" outside a fleet)

    def _build_pod(self):
        shape = self._seq % len(_SHAPES)
        cpu, mem, labels, zone = _SHAPES[shape]
        name = f"churn-{self._seq}"
        self._seq += 1
        return name, _make_pod(name, cpu, mem, labels, zone), shape

    def prebuild(self, n: int) -> None:
        """Construct n arrival pods ahead of time (a real apiserver receives
        pods over the wire — object construction is the event SOURCE's cost,
        not the serving loop's; the measured phase should apply events, not
        manufacture them)."""
        for _ in range(n):
            self._prebuilt.append(self._build_pod())

    def apply_arrivals(self, n: int) -> int:
        store = self.env.store
        log = self._event_log is not None
        for _ in range(n):
            name, pod, shape = self._prebuilt.popleft() if self._prebuilt else self._build_pod()
            if log:
                cpu, mem, labels, zone = _SHAPES[shape]
                self._log(op="arrive", name=name, cpu=cpu, memory=mem, labels=labels, zone=zone)
            # adopt: the harness relinquishes the pod object on creation
            store.create(pod, adopt=True)
            self._pending.append(name)
        self._record_events(n, "arrival")
        return n

    def apply_cancels(self, n: int) -> int:
        done = 0
        n_new = int(n * self.spec.cancel_newest_frac)
        while done < n_new and self._pending:
            name = self._pending.pop()  # newest first
            if self.env.store.try_delete("Pod", name, namespace="default"):
                self._log(op="cancel", name=name)
                done += 1
        while done < n and self._pending:
            name = self._pending.popleft()  # oldest: already-placed pods
            pod = self.env.store.borrow_get("Pod", name, "default")
            if pod is None:
                continue
            if pod.spec.node_name:
                self._bound.append(name)  # bound since we last looked
                continue
            self.env.store.try_delete("Pod", name, namespace="default")
            self._log(op="cancel", name=name)
            done += 1
        self._record_events(done, "departure")
        return done

    def apply_departures(self, n: int) -> int:
        done = 0
        while done < n and self._bound:
            name = self._bound.popleft()
            if self.env.store.try_delete("Pod", name, namespace="default"):
                self._log(op="depart", name=name)
                done += 1
        self._record_events(done, "departure")
        return done

    def apply_revocations(self, n: int) -> int:
        """Spot-style capacity revocation: n nodes are reclaimed out from
        under the fleet. Node choice is seeded (the injector's rng over the
        sorted name list) and each revocation is logged as an explicit
        `revoke` op, so a replayed log reproduces the exact reclaim."""
        if n <= 0 or self.env is None:
            return 0
        names = sorted(nd.metadata.name for nd in self.env.store.borrow_list("Node"))
        if not names:
            return 0
        rng = self.injector.rng if self.injector is not None else None
        picks = rng.sample(names, min(n, len(names))) if rng is not None else names[: min(n, len(names))]
        events = 0
        for name in picks:
            events += self.revoke_node(name)
        return events

    def revoke_node(self, name: str) -> int:
        """Decode one capacity revocation as FORCED DEPARTURES into the
        churn stream: the node's bound pods are deleted (the workload they
        carried is gone with the capacity), then the Node and its NodeClaim
        are removed with no graceful drain — exactly what a spot reclaim
        looks like to the control plane. Returns churn events applied."""
        store = self.env.store
        if store.try_get("Node", name) is None:
            return 0
        self._log(op="revoke", node=name)
        events = 0
        for pname in [p.metadata.name for p in store.borrow_list("Pod") if p.spec.node_name == name]:
            if store.try_delete("Pod", pname, namespace="default"):
                events += 1
                try:
                    self._bound.remove(pname)
                except ValueError:
                    try:
                        self._pending.remove(pname)
                    except ValueError:
                        pass
        self._record_events(events, "departure")
        claim = next(
            (nc.metadata.name for nc in store.borrow_list("NodeClaim") if nc.status.node_name == name),
            None,
        )
        # forced: no finalizer-gated drain (grace=False), mirror out of
        # cluster state like the chaos node-kill idiom
        try:
            store.delete("Node", name, grace=False)
        except Exception:  # solverlint: ok(swallowed-exception): NotFound race with a concurrent teardown — the node is gone either way, which is the goal
            pass
        self.env.cluster.delete_node(name)
        if claim is not None:
            try:
                store.delete("NodeClaim", claim, grace=False)
            except Exception:  # solverlint: ok(swallowed-exception): NotFound race with a concurrent teardown — the claim is gone either way, which is the goal
                pass
        return events

    def repack_savings(self, mode: str = "global", seed: int = 0) -> float:
        """faultline's revocation path as globalpack's second customer: after
        a spot reclaim (`revoke_node` / `apply_revocations`), measure the
        $/hr the chosen proposer's best EXACT-VALIDATED consolidation
        command would recover over the shrunken fleet. mode="global" runs
        the joint provisioning+retirement convex solve (the
        KARPENTER_SOLVER_GLOBALPACK path — orphaned pods still pending enter
        the solve as unconditional mass), mode="two-phase" the default
        greedy LP ladder. Nothing executes — the command is computed and
        scored only, so a bench gate can compare both modes on one fleet.
        Advances the fake clock past consolidate_after to surface candidates."""
        from ..controllers.disruption.methods import MultiNodeConsolidation, _command_savings_per_hour

        env = self.env
        env.clock.step(40)
        env.nodeclaim_disruption.reconcile()
        ctx = env.disruption.ctx
        ctx.round_candidates = env.disruption.get_candidates()
        ctx.node_pool_totals = None
        method = MultiNodeConsolidation(ctx)
        candidates = method.sort_candidates([c for c in ctx.round_candidates if method.should_disrupt(c)])
        if len(candidates) < 2:
            return 0.0
        deadline = ctx.clock.now() + 60.0
        if mode == "global":
            cmd = method._globalpack_option(candidates, deadline)
        else:
            cmd = method._lp_option(candidates, deadline)
        return _command_savings_per_hour(cmd) if cmd.candidates else 0.0

    def bind_flush(self) -> None:
        """Launch claims, register nodes, bind pending pods — the controller
        work between solves. Re-files newly bound pods from pending to bound."""
        self._log(op="bind_flush")
        env = self.env
        if hasattr(env.cloud_provider, "flush_pending"):
            env.cloud_provider.flush_pending()
        env.lifecycle.reconcile_all()
        if hasattr(env.cloud_provider, "flush_pending"):
            env.cloud_provider.flush_pending()
        env.lifecycle.reconcile_all()
        env.binder.bind_all()
        still = deque()
        for name in self._pending:
            pod = env.store.borrow_get("Pod", name, "default")
            if pod is None:
                continue
            if pod.spec.node_name:
                self._bound.append(name)
            else:
                still.append(name)
        self._pending = still

    def solve(self, force: bool = False):
        """Advance the fake clock past the idle window and pump one serving
        iteration (plus any coalesced drain generations). In fleet mode the
        pump goes through the FleetFrontend's DRR round — the push-wake path
        the watch events already armed — instead of the private loop."""
        self._log(op="solve", force=bool(force))
        self.env.clock.step(self.spec.batch_idle_seconds + 0.05)
        if self.fleet is not None:
            # scope to the attached tenant: a per-tenant warmup solve must
            # not fan out as a forced reconcile of every OTHER tenant
            served = self.fleet.pump(force=force, only=self._tenant_id)
            return served or None
        out = self.loop.pump(force=force)
        self.loop.drain()
        return out

    # -- phases ----------------------------------------------------------------
    def provision_base_fleet(self) -> None:
        """Create and bind the base fleet (cold compiles paid here)."""
        step = max(1, self.spec.n_base_pods // 4)
        created = 0
        while created < self.spec.n_base_pods:
            created += self.apply_arrivals(min(step, self.spec.n_base_pods - created))
            self.solve(force=True)
            self.bind_flush()
        # settle stragglers
        for _ in range(5):
            if not self._pending:
                break
            self.solve(force=True)
            self.bind_flush()

    def run_cycle(self, arrivals: int | None = None, cancels: int | None = None, departures: int | None = None) -> int:
        """One steady cycle: bind_every iterations of (arrivals + cancels +
        solve), with departures + bind flush on the cycle boundary. Returns
        events applied."""
        s = self.spec
        arrivals = s.arrivals if arrivals is None else arrivals
        cancels = s.cancels if cancels is None else cancels
        departures = s.departures if departures is None else departures
        events = 0
        for i in range(s.bind_every):
            events += self.apply_arrivals(arrivals)
            events += self.apply_cancels(cancels)
            self.solve()
            if i == s.bind_every - 1:
                events += self.apply_departures(departures)
                if self.injector is not None:
                    # spot-style revocation at the cycle boundary: forced
                    # departures + node teardown, then the bind flush lets
                    # the controllers start replacing the capacity
                    events += self.apply_revocations(self.injector.take_revocations())
                self.bind_flush()
        return events

    def run(self) -> ChurnReport:
        """Warmup cycles (cold compiles + high-water marks), then the
        measured steady phase. With `spec.replay_events` set, the recorded
        log drives everything instead (see run_replay)."""
        s = self.spec
        if s.replay_events is not None:
            return self.run_replay()
        if self.env is None:
            self.build()
        if self._event_log is not None:
            self._log(
                op="header",
                n_base_pods=s.n_base_pods, n_types=s.n_types, arrivals=s.arrivals,
                cancels=s.cancels, departures=s.departures, bind_every=s.bind_every,
                seed=s.seed, batch_idle_seconds=s.batch_idle_seconds,
                faults=(s.faults.to_dict() if s.faults is not None else None),
            )
        self.provision_base_fleet()
        # free steady-state headroom up front: arrivals land on capacity that
        # departures keep releasing; without this the first cycles would
        # create claims every solve (fleet growth, not steady churn)
        headroom = int((s.arrivals - s.cancels) * s.bind_every * 3)
        self.apply_departures(headroom)
        self.bind_flush()
        # bounding cycle: every churn-varying axis (pending backlog, delta
        # item count, removal count, nnz caps) is pushed PAST its steady-state
        # maximum so the high-water marks — and the one-time compiles they
        # imply — are all established before the sentinel mark; steady-state
        # batch variance then stays strictly inside compiled shapes
        self.run_cycle(
            arrivals=int(s.arrivals * 1.4) + 32,
            cancels=int(s.cancels * 1.6) + 32,
            departures=int(s.departures * 1.4) + 32,
        )
        for _ in range(s.warmup_cycles):
            self.run_cycle()
        # -- steady phase ------------------------------------------------------
        self.prebuild(s.arrivals * s.iterations)
        self._log(op="mark")
        mark = self.recorder.seq
        emark, slo0 = self._etracer_mark()
        rejects0 = self._reject_counts()
        recoveries0 = self._recovery_counts()
        coalesced0 = self.env.registry.counter(m.SOLVER_CHURN_COALESCED_TOTAL).total()
        reused0 = self.loop.prestager.reused if self.loop.prestager is not None else 0
        staged0 = self.loop.prestager.staged if self.loop.prestager is not None else 0
        events = 0
        t0 = time.perf_counter()
        done = 0
        while done < s.iterations:
            events += self.run_cycle()
            done += s.bind_every
        wall = time.perf_counter() - t0
        rep = self._report(mark, events, wall, coalesced0, reused0, staged0, emark, slo0)
        rejects1 = self._reject_counts()
        rep.full_solve_reasons = {
            k: int(v - rejects0.get(k, 0)) for k, v in rejects1.items() if v > rejects0.get(k, 0)
        }
        self._fault_columns(rep, recoveries0)
        if s.concurrent_seconds > 0:
            cev, csolves = self.run_concurrent(s.concurrent_seconds)
            rep.concurrent_events = cev
            rep.concurrent_solves = csolves
            rep.coalesced_triggers = int(
                self.env.registry.counter(m.SOLVER_CHURN_COALESCED_TOTAL).total() - coalesced0
            )
            # the zero-recompile claim covers the ENTIRE sustained run —
            # re-tally over every post-mark trace so a compile landing in
            # the concurrent segment (or its settle tail) fails the gate
            # instead of hiding outside the steady window
            recompiles: dict[str, int] = {}
            for t in self.recorder.traces():
                if t.seq > mark:
                    for fn, cnt in t.recompiles.items():
                        recompiles[fn] = recompiles.get(fn, 0) + cnt
            rep.recompiles = recompiles
            rep.steady_recompiles = sum(recompiles.values())
        if self._event_log is not None and s.record_path:
            self.dump_event_log(s.record_path)
        return rep

    # -- record/replay ---------------------------------------------------------
    def dump_event_log(self, path: str) -> int:
        """Write the recorded event stream as JSONL; returns ops written."""
        ops = self._event_log or []
        with open(path, "w") as f:
            for op in ops:
                f.write(json.dumps(op) + "\n")
        return len(ops)

    def apply_op(self, op: dict) -> int:
        """Apply one non-solve replay op; returns churn events applied.
        Solve ops are the DRIVER's job (run_replay calls self.solve; the
        multi-tenant bench paces them through the fleet pump instead)."""
        kind = op["op"]
        if kind == "arrive":
            pod = _make_pod(op["name"], op["cpu"], op["memory"], op.get("labels"), op.get("zone"))
            self.env.store.create(pod, adopt=True)
            self._pending.append(op["name"])
            self._record_events(1, "arrival")
            return 1
        if kind in ("cancel", "depart"):
            name = op["name"]
            if not self.env.store.try_delete("Pod", name, namespace="default"):
                return 0
            try:
                self._pending.remove(name)
            except ValueError:
                try:
                    self._bound.remove(name)
                except ValueError:
                    pass
            self._record_events(1, "departure")
            return 1
        if kind == "revoke":
            return self.revoke_node(op["node"])
        if kind == "bind_flush":
            self.bind_flush()
            return 0
        if kind in ("header", "mark"):
            return 0
        raise ValueError(f"unknown replay op {kind!r}")

    def run_replay(self) -> ChurnReport:
        """Drive the harness from `spec.replay_events`, deterministically:
        the recorded arrive/cancel/depart/solve/bind_flush sequence replays
        verbatim, the recorded `mark` op opens the measured window, and the
        report comes from the same machinery as a generated run."""
        s = self.spec
        if self.env is None:
            self.build()
        mark = self.recorder.seq
        emark, slo0 = self._etracer_mark()
        rejects0 = self._reject_counts()
        recoveries0 = self._recovery_counts()
        coalesced0 = self.env.registry.counter(m.SOLVER_CHURN_COALESCED_TOTAL).total()
        reused0 = self.loop.prestager.reused if self.loop.prestager is not None else 0
        staged0 = self.loop.prestager.staged if self.loop.prestager is not None else 0
        events = 0
        t0 = time.perf_counter()
        for op in s.replay_events:
            kind = op["op"]
            if kind == "solve":
                self.solve(force=op.get("force", False))
            elif kind == "mark":
                # steady window opens HERE, exactly like the generated run
                mark = self.recorder.seq
                emark, slo0 = self._etracer_mark()
                rejects0 = self._reject_counts()
                recoveries0 = self._recovery_counts()
                coalesced0 = self.env.registry.counter(m.SOLVER_CHURN_COALESCED_TOTAL).total()
                reused0 = self.loop.prestager.reused if self.loop.prestager is not None else 0
                staged0 = self.loop.prestager.staged if self.loop.prestager is not None else 0
                events = 0
                t0 = time.perf_counter()
            else:
                events += self.apply_op(op)
        wall = time.perf_counter() - t0
        rep = self._report(mark, events, wall, coalesced0, reused0, staged0, emark, slo0)
        rejects1 = self._reject_counts()
        rep.full_solve_reasons = {
            k: int(v - rejects0.get(k, 0)) for k, v in rejects1.items() if v > rejects0.get(k, 0)
        }
        self._fault_columns(rep, recoveries0)
        return rep

    def run_concurrent(self, seconds: float, batch: int | None = None) -> tuple[int, int]:
        """Wall-clock segment with a concurrent event driver: arrivals and
        cancellations land WHILE solves are in flight, so trigger bursts
        coalesce through the batcher's in-flight window into single
        follow-up solves. The driver paces itself against a pending-backlog
        cap (admission control): an unbounded flood would push the snapshot
        past the warmup's high-water shapes and turn the segment into a
        compile storm instead of a serving measurement. Returns (events
        applied, solves run)."""
        from ..obs.racecheck import make_event, spawn_thread

        stop = make_event()
        applied = [0]
        if batch is None:
            batch = max(20, self.spec.arrivals // 8)
        backlog_cap = self.spec.arrivals * max(2, self.spec.bind_every - 1)

        # declared in the thread-shared registry ([tool.solverlint]
        # thread-shared): the driver mutates only the store (lock-guarded),
        # the harness's deques (atomic append/pop, single consumer per end),
        # and the applied[0] cell it exclusively owns while running
        def _churn_driver():
            while not stop.is_set():
                if len(self._pending) < backlog_cap:
                    applied[0] += self.apply_arrivals(batch)
                    applied[0] += self.apply_cancels(int(batch * 0.75))
                time.sleep(0.001)

        solves0 = self.loop.solves
        t = spawn_thread(_churn_driver, name="churn-driver")
        deadline = time.perf_counter() + seconds
        try:
            while time.perf_counter() < deadline:
                self.solve()
        finally:
            stop.set()
            t.join(timeout=5)
        # settle the backlog the driver left behind
        for _ in range(5):
            if not self._pending:
                break
            self.solve(force=True)
            self.bind_flush()
        return applied[0], self.loop.solves - solves0

    def _reject_counts(self) -> dict:
        """Current delta-reject counter values by reason (cumulative)."""
        out: dict = {}
        for labels, v in self.env.registry.counter(m.SOLVER_DELTA_REJECT_TOTAL).collect():
            out[labels.get("reason", "?")] = v
        return out

    def _recovery_counts(self) -> dict:
        """Current recovery-ladder counter values by stage (cumulative)."""
        out: dict = {}
        for labels, v in self.env.registry.counter(m.SOLVER_RECOVERY_TOTAL).collect():
            out[labels.get("stage", "?")] = v
        return out

    def _fault_columns(self, rep: "ChurnReport", recoveries0: dict) -> None:
        """Fill the report's faultline columns (no-ops without an injector,
        except recoveries — the ladder also absorbs REAL failures)."""
        recov1 = self._recovery_counts()
        rep.recoveries = {
            k: int(v - recoveries0.get(k, 0)) for k, v in recov1.items() if v > recoveries0.get(k, 0)
        }
        prestager = self.loop.prestager if self.loop is not None else None
        rep.prestage_worker_restarts = prestager.restarts if prestager is not None else 0
        if self.injector is not None:
            rep.faults_injected = self.injector.summary()
            rep.revoked_nodes = int(rep.faults_injected.get("revocation", 0))

    def _etracer(self):
        """The environment's podtrace event tracer (None when off/absent)."""
        tr = getattr(self.env, "podtracer", None) if self.env is not None else None
        return tr if tr is not None and tr.enabled else None

    def _etracer_mark(self) -> tuple[int, int]:
        """(completed-event seq, SLO breach count) at the steady mark — the
        window the e2e report columns are computed over."""
        tr = self._etracer()
        return (tr.seq, tr.slo.breaches) if tr is not None else (0, 0)

    def _report(self, mark: int, events: int, wall: float, coalesced0: float = 0.0, reused0: int = 0, staged0: int = 0, emark: int = 0, slo0: int = 0) -> ChurnReport:
        traces = [t for t in self.recorder.traces() if t.seq > mark and t.mode not in ("", "consolidate")]
        durs = sorted(t.duration for t in traces)
        modes: dict[str, int] = {}
        recompiles: dict[str, int] = {}
        for t in traces:
            modes[t.mode] = modes.get(t.mode, 0) + 1
            for fn, n in t.recompiles.items():
                recompiles[fn] = recompiles.get(fn, 0) + n
        delta = modes.get("delta", 0) + modes.get("hybrid-delta", 0)
        eps = [t.n_pods for t in traces]
        rep = ChurnReport(
            events=events,
            wall_seconds=wall,
            events_per_sec=(events / wall) if wall > 0 else 0.0,
            solves=len(traces),
            modes=modes,
            delta_hit_rate=(delta / len(traces)) if traces else 0.0,
            p50_solve_seconds=quantile(durs, 0.50, assume_sorted=True) if durs else 0.0,
            p99_solve_seconds=quantile(durs, 0.99, assume_sorted=True) if durs else 0.0,
            recompiles=recompiles,
            steady_recompiles=sum(recompiles.values()),
            coalesced_triggers=int(self.env.registry.counter(m.SOLVER_CHURN_COALESCED_TOTAL).total() - coalesced0),
            # pending-backlog size per solve, NOT the trigger-drain ratio
            # (that one is the karpenter_solver_churn_events_per_solve
            # histogram, fed from the batcher generation)
            pods_per_solve_p50=quantile(sorted(eps), 0.5, assume_sorted=True) if eps else 0.0,
            prestage_reused=(self.loop.prestager.reused - reused0) if self.loop.prestager is not None else 0,
            prestage_staged=(self.loop.prestager.staged - staged0) if self.loop.prestager is not None else 0,
            n_nodes=len(self.env.cluster.nodes()),
            n_pending_end=len(self._pending),
        )
        tr = self._etracer()
        if tr is not None:
            recs = tr.events_since(emark)
            if recs:
                stage_rows = [r.stage_view() for r in recs]
                e2e = sorted(s["e2e"] for s in stage_rows)
                rep.e2e_events = len(e2e)
                rep.e2e_p50_seconds = quantile(e2e, 0.50, assume_sorted=True)
                rep.e2e_p99_seconds = quantile(e2e, 0.99, assume_sorted=True)
                from ..obs.podtrace import STAGES

                rep.stage_p99_seconds = {
                    st: quantile(sorted(s[st] for s in stage_rows), 0.99, assume_sorted=True) for st in STAGES if st != "e2e"
                }
                # dominance over the ADDITIVE decomposition (coalesce +
                # sched_wait + solve == e2e); prestage overlaps and decode
                # trails placement, so neither can "dominate" the e2e
                means = {
                    st: sum(s[st] for s in stage_rows) / len(stage_rows)
                    for st in ("coalesce", "sched_wait", "solve")
                }
                rep.dominant_stage = max(means, key=means.get)
            rep.slo_breaches = tr.slo.breaches - slo0
        return rep
