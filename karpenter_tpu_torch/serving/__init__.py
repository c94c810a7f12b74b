"""Steady-state churn serving: the solver as a long-lived service.

The port's copy of the reference's `serving/` (reference text, relative
imports kept). Its solvers are `GPUSolver`s on the device each entry point
is given (`ChurnHarness(device=)`, `FleetFrontend(device=)`,
`ShardRouter(device=)`; None is the CUDA device, "cpu" the kernels' plain
versions); the serving path launches K1-K3 on every full and adding delta
solve, K4 on every delta that removes placed pods, and K5-K6 on every
global repack plan. A kernel's or the device's failure inside a pump is
never answered by the host FFD: it reaches the fleet's breaker like any
other pump failure.

Every bench before this subsystem measured one-shot or single-warm-re-solve
latency; a production deployment is a long-lived `Provisioner`+`GPUSolver`
under sustained pod arrivals/departures from millions of users. This package
makes that regime first-class:

- `prestage.PendingPrestager` — the serving loop's double buffer: the NEXT
  solve's host-side encode/classify work (pod clone, validation verdict,
  signature stamping) runs while the CURRENT solve's device pack is in
  flight, and clone identity is preserved across solves so the encoder can
  classify consecutive serving snapshots as pod deltas.
- `loop.ServingLoop` — wires a prestager into a live Provisioner and pumps
  coalesced solves (the batcher's in-flight-aware drain: N triggers during a
  solve cost ONE batched follow-up solve).
- `churn.ChurnHarness` — drives sustained arrivals/departures against the
  live stack and reports throughput (pod-events/sec), P50/P99 re-solve
  latency, delta-hit rate, and the recompile count (the zero-steady-state
  gate, via the solvetrace sentinel). Gains record/replay: the generated
  event stream dumps as JSONL and `ChurnSpec.from_event_log()` replays it
  deterministically (one recorded log can drive K fleet tenants).
- every stage of that journey is flight-recorded per EVENT by podtrace
  (obs/podtrace.py): watch-event arrival (store delivery seam) ->
  coalescing-window residency -> fleet DRR sched wait -> prestage
  staged/missed -> solve (linked to the SolveTrace by seq) -> bind, with
  per-tenant per-stage quantiles, an SLO budget, and `/debug/events`.
- `fleet.FleetFrontend` / `fleet.TenantSession` — the multi-tenant front
  end: ONE solver process multiplexes many tenant clusters (per-tenant
  Store/Provisioner/EncodeCache/resident carry), watch events wake the
  fleet loop push-style (the batcher idle/max window becomes a coalescing
  bound, not a latency floor), a deficit-round-robin policy keeps bursty
  tenants from starving the rest, and tenants share pack-kernel launch
  SHAPES (process-global high-water marks + signature interning — never
  tensors; `isolation_audit()` enforces the split). With
  KARPENTER_SOLVER_COMPILE_CACHE=<dir> the built kernel library persists
  across process restarts and replicas.
- `shard.ShardRouter` / `shard.ShardRing` — shardfleet: the tenant→PROCESS
  scale-out. The router spawns N shard worker processes (each its own
  FleetFrontend serve loop over a consistent-hash slice of the tenants),
  shares one kernel build directory so the kernels are built once for all
  shards, partitions visible devices per shard
  (KARPENTER_SOLVER_SHARD_DEVICES), aggregates /debug/tenants +
  /debug/solves + /debug/events + the fleet metric families across shards
  (bounded `shard` label), and re-homes a dead shard's tenants by
  tenant-filtered recorded-log replay under per-shard circuit breakers.
- `faults.FaultSpec` / `faults.FaultInjector` / `faults.CircuitBreaker` —
  faultline: deterministic seeded fault injection at the named serving
  seams (solve exception / decode failure / slow solve, watch-stream
  drop·dup·reorder, prestager-worker death, spot-style capacity
  revocation), per-tenant circuit breakers at the fleet dispatch seam (K
  consecutive pump failures QUARANTINE one tenant; exponential-backoff
  half-open probes re-admit it; healthy tenants never miss a round), and
  the solver's graceful-degradation ladder (delta -> quarantined full
  re-encode -> host FFD) behind `GPUSolver.solve`. Observable via
  `karpenter_solver_tenant_state{tenant,state}`,
  `karpenter_solver_recovery_total{stage}`, and `/debug/tenants`.

Escape hatches: KARPENTER_SOLVER_DOUBLEBUF=0 disables the prestager (clones
rebuilt per pass, the pre-serving-loop behavior); KARPENTER_SOLVER_BUCKET=0
disables high-water shape bucketing (models/scheduler_model.py).

Thread-and-lock inventory (racecheck)
=====================================

This is the inventory the `lock-order` rule and the runtime sanitizer
(obs/racecheck.py, KARPENTER_SOLVER_RACECHECK=1) enforce. Threads first —
the serving stack's long-lived ones, every entry a reviewed seam in the
`[tool.solverlint] thread-shared` registry:

- the SOLVE thread (whoever pumps ServingLoop / Environment.tick);
- `karpenter-fleet` (FleetFrontend._serve_loop): the multi-tenant DRR
  scheduling loop — sleeps on the fleet wake event (or the nearest batcher
  `eta()`), then pumps runnable tenants; all solves in fleet mode run here;
- `karpenter-prestage` (PendingPrestager._run): drains watch events into the
  clone cache, overlapping the device pack;
- `churn-driver` (churn._churn_driver): the harness's concurrent event
  source, mutating only the store and the harness's atomic deques;
- `karpenter-operator-http` (+ per-request ThreadingHTTPServer workers):
  /metrics, /debug/solves, probes — read-only surfaces over lock-guarded
  state;
- `karpenter-lease-renewer` (LeaderElector.renew_loop): renews the lease
  through the store's optimistic concurrency;
- `karpenter-shard-drive-*` (ShardRouter._drive_shard): shardfleet run_all
  fan-out — one thread per shard, each exclusively owning its results key
  and its shard's handle (pipe I/O serialized under shard-handle);
- `karpenter-shard-monitor` (ShardRouter._monitor_loop): the router's
  breaker-driven shard health prober — pings through ShardHandle.call and
  mutates only breaker/registry state;
- `karpenter-shard-tick` (shard._tick_loop, worker process): live-mode
  controller rounds (env.tick(provision=False)) over the shard's tenant
  sessions, same division of labor as __main__._run_fleet's main loop;
- watch DELIVERY runs on whatever thread committed the store write, under
  `Store._deliver_lock` — every watch callback executes there.

Locks (constructed via obs.racecheck make_lock/make_rlock; the name is the
lock CLASS — instances share a graph node) and who guards what:

==================  =======================================================
lock name           guards
==================  =======================================================
store               Store._objects/_watchers/_rv/_kind_rv/_pending (RLock)
store-deliver       watch-event FIFO delivery (RLock; reentrant for
                    watchers that write back to the store)
cluster             Cluster's node/binding/ack mirrors (RLock)
batcher             Batcher trigger + in-flight bracket counters
fleet               FleetFrontend tenant registry + runnable set + DRR
                    deficits + breakers map + shed stamps + serve-thread
                    handle (leaf: only container ops run under it; solves
                    always run unlocked)
fleet-session       TenantSession wake-signal stats (leaf)
fleet-labels        the bounded tenant-label assignment table (leaf)
fleet-registry      the process-global fleet list backing /debug/tenants
                    (leaf)
faults              FaultInjector seam indices / fired counts / reorder
                    hold slot (leaf; metric emission runs OUTSIDE it)
breaker             CircuitBreaker state machine — pump-loop writes,
                    /debug/tenants HTTP reads (leaf)
prestage            PendingPrestager clone cache + staged/reused/misses
                    stats + worker thread handle
metric / metric-    every _Metric's series maps / Registry._metrics (RLock)
registry
trace               TraceRecorder ring, windows, seq, dropped
podtrace            PodTracer active/awaiting maps, completed ring, stage
                    windows, SLO + wake stats (leaf; metric emission runs
                    OUTSIDE it), plus the module-level tenant-surface
                    registry in obs/podtrace.py
events              Recorder.events + dedupe map (RLock)
clock               FakeClock._t
leader              LeaderElector._leading/_last_renew
nodepool-health     registration-health trackers (RLock)
operator-server     OperatorServer httpd/thread handles
shard-router        ShardRouter handle/port/tenant/breaker maps + ring +
                    monitor-thread handle (leaf: shard calls and breaker
                    methods always run unlocked)
shard-handle        one ShardHandle's Popen + pipe protocol framing (leaf;
                    the readline is plain pipe I/O, not a blocking call in
                    the lock-order sense)
shard-labels        the bounded shard-label assignment table (leaf)
==================  =======================================================

SANCTIONED ORDER (acquire left before right; the dynamic graph must stay a
DAG, and the sanitizer raises on the first acquisition that closes a
cycle):

    store-deliver  ->  { store, cluster, batcher, prestage, clock, metric*,
                         fleet-session, fleet, podtrace, faults }
    cluster        ->  { store, clock }
    trace          ->  { metric-registry, metric }
    events | store | batcher | prestage  ->  clock

(store-deliver -> podtrace is the arrival-stamp seam: `Store._drain` hands
every delivered event to the installed PodTracer before the watcher fan-out;
every other podtrace touch point — dispatch/solved on the solve thread,
prestage stamps after the prestage lock releases, wake counts after the
fleet lock releases — acquires it as a leaf. store-deliver -> faults is the
faultline watch-stream seam: `_drain` asks the installed FaultInjector to
drop/dup/reorder each Pod delivery; the solver/prestager/revocation seams
acquire `faults` as a leaf from their own threads.)

(The fleet edges are the push-wake path: watch delivery -> batcher trigger
-> wake_hook -> TenantSession stats -> FleetFrontend runnable set, each
lock RELEASED before the next is taken except the ambient store-deliver.)

Everything else is leaf-only. Two rules keep it that way: (1) never WRITE
to the store while holding `cluster` (a write drains watches under
store-deliver — the reverse edge); (2) never solve, device-sync, or call
`store._drain` while holding ANY lock (the lock-order rule flags those
statically) — the fleet loop obeys the same discipline: `FleetFrontend.pump`
releases the fleet lock around every `ServingLoop.pump`.
"""

from .churn import ChurnHarness, ChurnReport, ChurnSpec  # noqa: F401
from .faults import CircuitBreaker, FaultInjector, FaultRule, FaultSpec  # noqa: F401
from .fleet import FleetFrontend, TenantSession, tenant_label  # noqa: F401
from .loop import ServingLoop, doublebuf_enabled  # noqa: F401
from .prestage import PendingPrestager  # noqa: F401
from .shard import ShardRing, ShardRouter, placement_digest, shard_label  # noqa: F401
