"""podtrace: end-to-end event-lifecycle tracing for the fleet serving path.

solvetrace (obs/trace.py) instruments the SOLVE; this module instruments the
EVENT — the journey a watch event makes from the store's delivery seam to a
placement decision. Every Pod watch event delivered by `kube/store.py` is
stamped with a monotonic arrival time and threaded, cross-thread, through
the whole serving stack:

- ARRIVAL: `Store._drain` calls `PodTracer.on_delivery` per delivered event
  (commit + delivery stamps) — a new provisionable pod opens an EventRecord,
  a DELETE cancels it, and a MODIFIED carrying `spec.node_name` is the bind
  completion that closes the decode stage.
- COALESCE: the record sits in the batcher's idle/max window until the
  provisioner takes the generation; `Provisioner.provision` stamps dispatch
  on every traced pod in the batch (`on_dispatch`) and links the batch
  summary (count, oldest-event age, window residency) into the SolveTrace so
  `explain()` can join both views.
- SCHED WAIT: in fleet mode, `FleetFrontend._observe_sched_wait` hands the
  tenant's DRR wait (plus round and banked credit at dispatch) to the
  tracer; the next dispatch's events carry it. Zero outside a fleet.
- PRESTAGE: `PendingPrestager` stamps when it stages a pod's clone ahead of
  a take (`on_prestaged`) and marks take-misses — staged-vs-missed is the
  double-buffer's observable surface. The prestage stamp OVERLAPS the
  coalescing window by design, so it is reported as an attribute, never
  added into the linear e2e decomposition.
- SOLVE: `on_solved` stamps solve completion for the dispatched batch,
  records the linking SolveTrace seq, and COMPLETES placed events — e2e is
  event-to-PLACEMENT (the product's headline number); the later bind stamp
  fills the `decode` stage (decode -> claim -> lifecycle -> bind) without
  reopening the record.

Completed records land in a bounded ring with rolling per-stage P50/P90/P99
(published as the bounded `karpenter_solver_event_stage_quantile_seconds
{tenant, stage, quantile}` family), an SLO budget tracker (configurable
target via KARPENTER_PODTRACE_SLO, breach counter + burn rate), and a
Perfetto export (`obs/export.events_to_trace_events`) where watch-delivery /
serve-loop / prestage-worker render as separate tracks joined by flow
arrows. `/debug/events` (+ `?tenant=`) on the OperatorServer dumps the ring.

The additive contract: for a completed record,
    e2e == coalesce + sched_wait + solve        (placement)
and `decode` extends past placement to the observed bind. Tracing is
default-on (KARPENTER_PODTRACE=0 disables), must never change placements
(tests pin bit-identical results on vs off), and its cost is gated by
bench `event_latency` at the churn_sustained headline scale via the direct
self-time meter (`start_selftime`). The hot path is priced accordingly: delivery stamps are a few dict ops under a
leaf lock, completions cache their stage decomposition once, and the
quantile gauges publish per /metrics SCRAPE, never per event. Like the
rest of obs/, importing this module imports no torch.
"""

from __future__ import annotations

import os
import time

from ..utils.ringbuffer import RingBuffer
from .racecheck import make_lock, touch
from .stats import quantile

# the bounded per-event stage enum (the `stage` metric label): the linear
# e2e decomposition plus the overlapped prestage stamp and the post-placement
# bind ("decode") tail. Quantile publication iterates exactly this tuple.
STAGES = ("coalesce", "sched_wait", "prestage", "solve", "decode", "e2e")

# the bounded fleet wake-cause enum (the `cause` label on
# karpenter_solver_fleet_wake_total): who made a tenant runnable first —
# the store watch seam, the batcher trigger hook, the serve loop's window
# (eta) timeout, the liveness poll floor, or a deterministic driver's rearm.
WAKE_CAUSES = ("watch-event", "batcher-window", "poll-floor", "rearm")

_QUANTILE_POINTS = {"p50": 0.50, "p90": 0.90, "p99": 0.99}
_MAX_ACTIVE = 200_000  # hard bound on in-flight records (pending backlog)


def _env_enabled() -> bool:
    return os.environ.get("KARPENTER_PODTRACE", "1").strip().lower() not in ("0", "false", "off")


def _env_slo() -> float:
    try:
        return float(os.environ.get("KARPENTER_PODTRACE_SLO", "0.25"))
    except ValueError:
        return 0.25


class EventRecord:
    """One watch event's lifecycle. Monotonic stamps are absolute
    perf-counter-family times; `to_dict` exports stage DURATIONS plus the
    wall-clock arrival so exports can place records on a shared timeline."""

    __slots__ = (
        "uid",
        "name",
        "key",
        "tenant",
        "seq",
        "rv",
        "wall_arrival",
        "t_arrival",
        "deliver_lag",
        "t_prestaged",
        "staged",
        "t_dispatch",
        "sched_wait",
        "drr_round",
        "drr_credit",
        "wake_cause",
        "t_solved",
        "solve_seq",
        "t_bound",
        "outcome",
        "stages",
    )

    def __init__(self, uid: str, name: str, tenant: str, rv, t_commit: float, t_deliver: float, key: str = ""):
        self.uid = uid
        self.name = name
        self.key = key or name
        self.tenant = tenant
        self.seq = 0  # assigned at completion (ring order)
        self.rv = rv
        self.wall_arrival = time.time()
        self.t_arrival = t_commit
        self.deliver_lag = max(0.0, t_deliver - t_commit)
        self.t_prestaged = 0.0
        self.staged = False
        self.t_dispatch = 0.0
        self.sched_wait = 0.0
        self.drr_round = 0
        self.drr_credit = 0.0
        self.wake_cause = ""
        self.t_solved = 0.0
        self.solve_seq = 0
        self.t_bound = 0.0
        self.outcome = ""  # "" in flight | placed | bound | cancelled | dropped
        # stage decomposition cached at completion (and patched at bind):
        # always recomputable from the stamps via stage_seconds() — the
        # cache exists so quantile reads over the ring cost dict lookups,
        # not recomputation, and completions skip per-stage window appends
        self.stages: dict[str, float] | None = None

    # -- derived stage durations ----------------------------------------------
    def stage_seconds(self) -> dict[str, float]:
        """The per-stage decomposition. `coalesce + sched_wait + solve` sums
        exactly to `e2e` (event-to-placement); `prestage` is the overlapped
        staging latency (informational) and `decode` the placement-to-bind
        tail observed from the bind's own watch event."""
        out = dict.fromkeys(STAGES, 0.0)
        if self.t_dispatch:
            out["sched_wait"] = self.sched_wait
            out["coalesce"] = max(0.0, self.t_dispatch - self.t_arrival - self.sched_wait)
        if self.staged and self.t_prestaged:
            hi = self.t_dispatch or self.t_prestaged
            out["prestage"] = max(0.0, min(self.t_prestaged, hi) - self.t_arrival)
        if self.t_solved and self.t_dispatch:
            out["solve"] = max(0.0, self.t_solved - self.t_dispatch)
            out["e2e"] = out["coalesce"] + out["sched_wait"] + out["solve"]
        if self.t_bound and self.t_solved:
            out["decode"] = max(0.0, self.t_bound - self.t_solved)
        return out

    def stage_view(self) -> dict[str, float]:
        """The cached stage decomposition when completed, else computed
        fresh from the stamps — the ONE cache-or-recompute seam every
        reader (to_dict, tracer stats, churn report, bench) goes through."""
        return self.stages if self.stages is not None else self.stage_seconds()

    def to_dict(self) -> dict:
        stages = self.stage_view()
        return {
            "seq": self.seq,
            "uid": self.uid,
            "name": self.name,
            "tenant": self.tenant,
            "wall_arrival": self.wall_arrival,
            "outcome": self.outcome,
            "staged": self.staged,
            "wake_cause": self.wake_cause,
            "sched_round": self.drr_round,
            "sched_credit": round(self.drr_credit, 3),
            "solve_seq": self.solve_seq,
            "deliver_lag_s": round(self.deliver_lag, 6),
            "stages": {k: round(v, 6) for k, v in stages.items()},
        }


class SLOBudget:
    """The event-latency SLO tracker: a configurable e2e target, a breach
    (burn) counter, and the remaining error budget against an allowed burn
    fraction. Mutated only under the owning tracer's lock."""

    __slots__ = ("target_seconds", "allowed_frac", "completed", "breaches")

    def __init__(self, target_seconds: float, allowed_frac: float = 0.01):
        self.target_seconds = float(target_seconds)
        self.allowed_frac = float(allowed_frac)
        self.completed = 0
        self.breaches = 0

    def observe(self, e2e: float) -> bool:
        self.completed += 1
        if e2e > self.target_seconds:
            self.breaches += 1
            return True
        return False

    def to_dict(self) -> dict:
        burn = (self.breaches / self.completed) if self.completed else 0.0
        return {
            "target_seconds": self.target_seconds,
            "allowed_breach_frac": self.allowed_frac,
            "completed": self.completed,
            "breaches": self.breaches,
            "burn_rate": round(burn, 6),
            "budget_remaining": round(max(0.0, 1.0 - burn / self.allowed_frac) if self.allowed_frac else 0.0, 6),
        }


class PodTracer:
    """The fleet-wide event flight recorder: one per tenant Environment
    (`env.podtracer`), hooked into the store's delivery seam and fed by the
    provisioner / fleet / prestager touch points above. Thread-safe: arrival
    and bind stamps land on watch-delivery threads (under the store's
    `_deliver_lock`), prestage stamps on the worker, dispatch/solve stamps on
    whatever thread pumps the loop — every mutation goes through `_lock`
    (leaf; metric emission happens OUTSIDE it, like the fleet's wake path)."""

    # racecheck guarded-field registry (analysis: guarded-field-access;
    # runtime: obs.racecheck.touch at the stat increments)
    GUARDED_FIELDS = {
        "_active": "_lock",
        "_awaiting_bind": "_lock",
        "_ring": "_lock",
        "_dispatched": "_lock",
        "_pending_sched": "_lock",
        "seq": "_lock",
        "dropped": "_lock",
        "cancelled": "_lock",
        "deliveries": "_lock",
        "wake_causes": "_lock",
        "prestage_misses": "_lock",
        "_dropped_published": "_lock",
    }

    def __init__(
        self,
        tenant: str = "",
        capacity: int = 2048,
        enabled: bool | None = None,
        slo_seconds: float | None = None,
        registry=None,
    ):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self.tenant = tenant
        self.capacity = int(capacity)
        self.registry = registry
        self._lock = make_lock("podtrace")
        self._active: dict[str, EventRecord] = {}
        self._awaiting_bind: dict[str, EventRecord] = {}
        self._ring: RingBuffer[EventRecord] = RingBuffer(self.capacity)
        # uids stamped by the LAST on_dispatch — exactly the solve's batch,
        # so on_solved can never complete a record the solve never saw
        self._dispatched: set[str] = set()
        self._pending_sched: tuple[float, int, float, str] | None = None
        self.seq = 0  # completed-record sequence (ring order, the churn mark)
        self.dropped = 0  # records evicted from the ring or refused at the cap
        self.cancelled = 0
        self.deliveries = 0  # pod watch events observed at the seam
        self.wake_causes: dict[str, int] = {}
        self.prestage_misses = 0
        self._dropped_published = 0  # this tracer's share already on the counter
        self.slo = SLOBudget(_env_slo() if slo_seconds is None else slo_seconds)
        # direct self-cost meter (bench `event_latency`): when armed via
        # `start_selftime()`, every tracer entry point accumulates its own
        # wall time here — an EXACT measure of the tracing cost that a
        # differential on/off comparison cannot deliver on a noisy box.
        # Unarmed (the default), the hot paths pay one attribute check.
        self.selftime = 0.0
        self._selftime_on = False

    # on_prestaged is deliberately ABSENT: it delegates to
    # on_prestaged_batch, whose armed wrapper would otherwise be timed a
    # second time through the instance-attribute lookup (double-counting)
    _SELFTIME_POINTS = (
        "on_delivery",
        "on_dispatch",
        "on_solved",
        "on_prestaged_batch",
        "on_take_miss",
        "on_wake",
        "note_sched_wait",
    )

    def start_selftime(self) -> None:
        """Arm the meter by shadowing every entry point with a timed
        instance-attribute wrapper — the unarmed hot path is untouched (the
        wrappers only exist while armed). `selftime` accumulation is plain
        (exact on the single-threaded bench harness; approximate if armed
        under concurrent delivery, which the bench never does)."""
        self.selftime = 0.0
        self._selftime_on = True
        for name in self._SELFTIME_POINTS:
            orig = getattr(type(self), name)

            def _timed(*a, _orig=orig, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(self, *a, **kw)
                finally:
                    self.selftime += time.perf_counter() - t0

            setattr(self, name, _timed)

    def stop_selftime(self) -> float:
        self._selftime_on = False
        for name in self._SELFTIME_POINTS:
            self.__dict__.pop(name, None)
        return self.selftime

    # -- the store delivery seam (watch threads, under _deliver_lock) ---------
    def on_delivery(self, event: str, obj, t_commit: float, t_deliver: float) -> None:
        """Stamp one delivered watch event. Borrow contract: `obj` is the
        stored object — read scalar fields only, never retain or mutate.

        HOT PATH (runs per pod watch event under the store's delivery lock;
        the bench `event_latency` overhead gate prices every branch): the
        counters mutate under `_lock` like the registry declares but skip
        the per-call `touch()` assertion — the low-rate touch points
        (dropped/misses/wakes) keep the runtime arm's coverage."""
        if not self.enabled or obj.kind != "Pod":
            return
        meta = obj.metadata
        uid = meta.uid
        if event == "MODIFIED":
            if meta.deletion_timestamp is None and not obj.spec.node_name:
                return  # spec/status churn on a pending pod: nothing to stamp
            with self._lock:
                self.deliveries += 1
                rec = self._active.pop(uid, None)
                if meta.deletion_timestamp is not None:
                    if rec is not None:
                        rec.outcome = "cancelled"
                        self.cancelled += 1
                    else:
                        self._awaiting_bind.pop(uid, None)
                    return
                if rec is not None:
                    # bound before on_solved saw the placement (direct bind)
                    self._awaiting_bind[uid] = rec
                    return
                waiting = self._awaiting_bind.pop(uid, None)
                if waiting is not None:
                    # the bind closes the decode stage of the already-
                    # completed record: the ring entry (and its cached
                    # stage decomposition) updates in place
                    waiting.t_bound = t_deliver
                    waiting.outcome = "bound"
                    if waiting.stages is not None and waiting.t_solved:
                        waiting.stages["decode"] = max(0.0, t_deliver - waiting.t_solved)
            return
        if event == "DELETED":
            with self._lock:
                self.deliveries += 1
                rec = self._active.pop(uid, None)
                if rec is not None:
                    rec.outcome = "cancelled"
                    self.cancelled += 1
                else:
                    self._awaiting_bind.pop(uid, None)
            return
        # ADDED: a new provisionable pod opens the lifecycle record
        if obj.spec.node_name or meta.deletion_timestamp is not None:
            return
        with self._lock:
            self.deliveries += 1
            if len(self._active) >= _MAX_ACTIVE:
                touch(self, "dropped")
                self.dropped += 1
                return
            self._active[uid] = EventRecord(
                uid, meta.name, self.tenant, meta.resource_version, t_commit, t_deliver,
                key=f"{meta.namespace}/{meta.name}",
            )

    # -- the prestager seams (worker thread / solve thread) -------------------
    def on_prestaged(self, uid: str) -> None:
        self.on_prestaged_batch((uid,))

    def on_prestaged_batch(self, uids) -> None:
        """Stamp a whole prestager pump's staged pods under ONE lock hold
        (the pump drains bursts of watch events; per-pod locking here showed
        up in the event_latency overhead gate)."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            active = self._active
            for uid in uids:
                rec = active.get(uid)
                if rec is not None and not rec.t_prestaged:
                    rec.t_prestaged = now
                    rec.staged = True

    def on_take_miss(self, uid: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            touch(self, "prestage_misses")
            self.prestage_misses += 1

    # -- fleet wake / DRR seams -----------------------------------------------
    def on_wake(self, cause: str) -> None:
        """Count a wake signal by its bounded cause (the first signal that
        marked this tenant runnable — attribution, not a trigger count)."""
        if not self.enabled:
            return
        with self._lock:
            touch(self, "wake_causes")
            self.wake_causes[cause] = self.wake_causes.get(cause, 0) + 1

    def note_sched_wait(self, seconds: float, drr_round: int = 0, credit: float = 0.0, cause: str = "") -> None:
        """The fleet measured this tenant's runnable->dispatch wait (plus
        the wake cause that opened the runnable episode); the next
        `on_dispatch` applies them to every event in that batch."""
        if not self.enabled:
            return
        with self._lock:
            self._pending_sched = (float(seconds), int(drr_round), float(credit), cause)

    # -- the provisioner seams (solve thread) ---------------------------------
    def on_dispatch(self, pods, window: dict | None = None, cause: str = "") -> dict | None:
        """The provisioner took a generation and assembled its batch: stamp
        dispatch on every traced pod. Returns the event-batch summary the
        solver links into its SolveTrace ({count, oldest_age_s [, window_s,
        sched_wait_s]}), or None when nothing in the batch is traced."""
        if not self.enabled:
            return None
        now = time.monotonic()
        oldest = 0.0
        n = 0
        with self._lock:
            sched = self._pending_sched
            self._pending_sched = None
            if sched is not None and not cause:
                cause = sched[3]  # the wake cause that opened the episode
            dispatched = self._dispatched = set()
            for pod in pods:
                uid = pod.metadata.uid
                rec = self._active.get(uid)
                if rec is None:
                    continue
                rec.t_dispatch = now
                dispatched.add(uid)
                if sched is not None:
                    rec.sched_wait, rec.drr_round, rec.drr_credit = sched[0], sched[1], sched[2]
                if cause and not rec.wake_cause:
                    rec.wake_cause = cause
                oldest = max(oldest, now - rec.t_arrival)
                n += 1
        if not n:
            return None
        batch = {"count": n, "oldest_age_s": round(oldest, 6)}
        if window and window.get("count"):
            batch["window_s"] = round(window.get("window_s", 0.0), 6)
        if sched is not None:
            batch["sched_wait_s"] = round(sched[0], 6)
        return batch

    def on_solved(self, results, solve_seq: int = 0) -> None:
        """The solve finished: stamp completion for the dispatched batch and
        COMPLETE every placed event (e2e = event-to-placement). Unplaced
        events keep their record and re-stamp on the next dispatch.

        Placement membership is derived by INVERSION over the LAST
        dispatched batch (the `_dispatched` set on_dispatch just built —
        never earlier batches' strays): the solver contract puts every
        batch pod either in a node/claim or in `pod_errors`, so a batch
        record completes unless its pod key is errored — the error set is
        tiny/empty in steady state, where the placed set is the whole
        backlog (the event_latency overhead gate prices this scan)."""
        if not self.enabled:
            return
        now = time.monotonic()
        errored = set(getattr(results, "pod_errors", None) or ()) if results is not None else set()
        solved = results is not None
        finished: list[EventRecord] = []
        breaches = 0
        with self._lock:
            dispatched, self._dispatched = self._dispatched, set()
            for uid in dispatched:
                rec = self._active.get(uid)
                if rec is None:
                    continue
                if solved and rec.key not in errored:
                    rec.t_solved = now
                    rec.solve_seq = solve_seq
                    rec.outcome = "placed"
                    del self._active[uid]
                    self._awaiting_bind[uid] = rec
                    finished.append(rec)
            if len(self._awaiting_bind) > _MAX_ACTIVE:
                # a bind that never comes must not pin records forever
                self._awaiting_bind.clear()
            ring, cap = self._ring, self.capacity
            slo_observe = self.slo.observe
            for rec in finished:
                self.seq += 1
                rec.seq = self.seq
                if len(ring) >= cap:
                    touch(self, "dropped")
                    self.dropped += 1
                ring.insert(rec)
                stages = rec.stages = rec.stage_seconds()
                if slo_observe(stages["e2e"]):
                    breaches += 1
        # metric emission OUTSIDE the podtrace lock (leaf discipline): the
        # registry's own locks order below whatever the caller holds already.
        # Only the cheap SLO burn counter is emitted here — the quantile
        # gauges publish SCRAPE-driven (`publish_quantiles`, called by the
        # OperatorServer's /metrics handler), so the serving hot path never
        # sorts a stage window.
        if self.registry is not None and breaches:
            from ..metrics import SOLVER_EVENT_SLO_BREACH_TOTAL

            try:
                self.registry.counter(SOLVER_EVENT_SLO_BREACH_TOTAL).inc(breaches, tenant=self.tenant)  # solverlint: ok(metric-label-cardinality): tenant is the fleet registration label (a serving.fleet.tenant_label output; "" outside a fleet) — the bounded fleet enum
            except Exception:  # noqa: BLE001  # solverlint: ok(swallowed-exception): observability must never fail a solve — a broken SLO counter drops one increment
                pass

    def publish_quantiles(self) -> None:
        """Publish the rolling per-stage quantile gauges + the dropped
        counter. Scrape-driven: the /metrics handler calls this per scrape
        (and tests/dashboards may call it directly), so the sort cost rides
        the scrape, never the serving path."""
        if self.registry is None or not self.enabled:
            return
        from ..metrics import (
            SOLVER_EVENT_STAGE_QUANTILE_SECONDS,
            SOLVER_EVENT_TRACE_DROPPED_TOTAL,
        )

        try:
            g = self.registry.gauge(SOLVER_EVENT_STAGE_QUANTILE_SECONDS)
            for stage, qs in self.stats().items():
                if not qs["n"]:
                    continue
                for qn in _QUANTILE_POINTS:
                    g.set(qs[qn], tenant=self.tenant, stage=stage, quantile=qn)  # solverlint: ok(metric-label-cardinality): stage iterates the static STAGES tuple and quantile the three-point enum — both bounded by construction
            with self._lock:
                # publish THIS tracer's delta, not a sync against the shared
                # counter total — in fleet mode every tenant tracer feeds the
                # same unlabeled family, so totals must sum across tracers
                delta = self.dropped - self._dropped_published
                self._dropped_published = self.dropped
            if delta > 0:
                self.registry.counter(SOLVER_EVENT_TRACE_DROPPED_TOTAL).inc(delta)
        except Exception:  # noqa: BLE001  # solverlint: ok(swallowed-exception): observability must never break a scrape — the dropped-counter delta retries next scrape
            pass

    # -- reading ---------------------------------------------------------------
    def events(self) -> list[EventRecord]:
        with self._lock:
            return self._ring.items()

    def events_since(self, seq: int) -> list[EventRecord]:
        return [r for r in self.events() if r.seq > seq]

    def stats(self, records: list[EventRecord] | None = None) -> dict[str, dict[str, float]]:
        """{stage: {n, p50, p90, p99}} over the completed-record ring. The
        rolling window IS the ring: each record's decomposition is cached at
        completion, so this read sorts on demand instead of the hot path
        maintaining per-stage windows per completion. Callers that already
        snapshotted the ring (dump) pass it in to skip a second copy."""
        if records is None:
            records = self.events()
        out: dict[str, dict[str, float]] = {}
        for stage in STAGES:
            samples = sorted(r.stage_view()[stage] for r in records)
            out[stage] = {
                "n": len(samples),
                **{qn: quantile(samples, p, assume_sorted=True) for qn, p in _QUANTILE_POINTS.items()},
            }
        return out

    def dump(self, limit: int | None = None) -> dict:
        """The /debug/events payload: ring content (oldest first), rolling
        per-stage quantiles, SLO budget, wake-cause attribution, health."""
        ring = self.events()  # ONE snapshot serves both stats and the slice
        records = ring if limit is None else (ring[-limit:] if limit > 0 else [])
        with self._lock:
            out = {
                "enabled": self.enabled,
                "tenant": self.tenant,
                "capacity": self.capacity,
                "completed": self.seq,
                "in_flight": len(self._active),
                "awaiting_bind": len(self._awaiting_bind),
                "cancelled": self.cancelled,
                "deliveries": self.deliveries,
                "dropped": self.dropped,
                "prestage_misses": self.prestage_misses,
                "wake_causes": dict(self.wake_causes),
            }
        out["slo"] = self.slo.to_dict()
        out["stats"] = self.stats(ring)
        out["events"] = [r.to_dict() for r in records]
        return out


# -- the per-tenant surface registry ------------------------------------------
# `/debug/events?tenant=` and `/debug/solves?tenant=` resolve tenants here:
# the fleet front-end registers each session's (TraceRecorder, PodTracer)
# pair at add_tenant and unregisters at remove. Module-scoped like the
# fleet's label table; constructed through the sanctioned factory.
_TENANTS: dict[str, tuple[object, object]] = {}
_TENANTS_LOCK = make_lock("podtrace")


def register_tenant(label: str, recorder, tracer) -> None:
    with _TENANTS_LOCK:
        _TENANTS[label] = (recorder, tracer)


def unregister_tenant(label: str) -> None:
    with _TENANTS_LOCK:
        _TENANTS.pop(label, None)


def tenant_surfaces() -> dict[str, tuple[object, object]]:
    with _TENANTS_LOCK:
        return dict(_TENANTS)


def reset_tenants() -> None:
    """Drop the registrations (test isolation)."""
    with _TENANTS_LOCK:
        _TENANTS.clear()
