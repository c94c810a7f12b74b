"""faultline: deterministic fault injection + failure-domain primitives for
the fleet serving stack.

Nothing in a long-lived serving process gets to assume a solve succeeds: a
`DecodeError` out of a poisoned delta base, a worker thread dying, a spot
reclaim yanking capacity mid-churn — the ROADMAP's sustained-disruption
regime. This module provides the two halves the stack composes:

- **FaultSpec / FaultInjector** — a SEEDED, deterministic fault plan that
  injects at named seams (the bounded `FAULT_SEAMS` enum):

  ==================  =======================================================
  seam                where it fires / what it models
  ==================  =======================================================
  solve-exception     `GPUSolver.solve` raises before the tensor path runs —
                      an arbitrary in-solve crash (driver bug, OOM-ish)
  decode-failure      a `tensor placement failed validation`-class failure:
                      the solver raises after its caches may be poisoned
  slow-solve          injected latency around the solve (`arg` seconds) —
                      the pathological-tenant input for overload protection
  watch-drop          a store watch event is never delivered (lossy stream)
  watch-dup           a store watch event is delivered twice (at-least-once)
  watch-reorder       a store watch event is deferred behind its successor
  prestage-death      the PendingPrestager worker thread dies (supervised +
                      restarted — the fix this fault forces)
  revocation          spot-style capacity revocation: `arg` nodes reclaimed
                      as forced departures through the ChurnHarness
  ==================  =======================================================

  Rules are index-scheduled (`at` / `every` / `count`) against per-seam
  monotone counters (solve attempts, delivered pod events, worker loop
  iterations, churn cycles), so the same spec against the same event stream
  injects at exactly the same points — recordable/replayable through the
  ChurnHarness JSONL event-log contract (the spec rides the log header;
  revocations ride the log as explicit `revoke` ops).

- **CircuitBreaker** — the per-tenant failure-domain gate the
  `FleetFrontend.pump()` dispatch seam consults: K consecutive pump
  failures open it (tenant QUARANTINED — the fleet keeps serving everyone
  else), exponential-backoff half-open probes re-admit it, and its state is
  observable (`karpenter_solver_tenant_state{tenant,state}`,
  `/debug/tenants`).

Determinism contract: with no FaultSpec installed every seam is a `None`
check — placements are bit-identical to a build without this module (tests
pin it), and an injected-then-recovered run converges to the same
placements as a clean run of the same event log.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from ..obs.racecheck import make_lock, touch

# the bounded seam enum: every `seam` metric label value and every
# FaultRule.seam is validated against this tuple at construction
FAULT_SEAMS = (
    "solve-exception",
    "decode-failure",
    "slow-solve",
    "watch-drop",
    "watch-dup",
    "watch-reorder",
    "prestage-death",
    "revocation",
)
_SOLVE_SEAMS = frozenset({"solve-exception", "decode-failure", "slow-solve"})
_WATCH_SEAMS = frozenset({"watch-drop", "watch-dup", "watch-reorder"})

# the breaker's bounded state enum — the `state` metric label values on
# karpenter_solver_tenant_state / karpenter_solver_breaker_transitions_total
TENANT_STATES = ("healthy", "quarantined", "probing")


class FaultInjected(RuntimeError):
    """An injected fault. `unrecoverable=True` models a hard failure the
    solver's degradation ladder must NOT absorb (it re-raises, so the fault
    escapes to the fleet's dispatch seam and trips the tenant breaker)."""

    def __init__(self, msg: str, seam: str = "solve-exception", unrecoverable: bool = False):
        super().__init__(msg)
        self.seam = seam
        self.unrecoverable = unrecoverable


@dataclass(frozen=True)
class FaultRule:
    """One scheduled fault: fire at index `at` of the seam's counter, then
    every `every` (0 = only at `at`), at most `count` times total. `arg` is
    the seam parameter (slow-solve sleep seconds; revocation node count).
    `ladder` is the number of solver ladder stages the fault poisons: 1 =
    the first attempt only (full-re-encode recovery succeeds), 2 = the
    re-encode retry fails too (host-FFD serves), 0 = UNRECOVERABLE (the
    ladder re-raises and the tenant breaker takes over)."""

    seam: str
    at: int = 0
    every: int = 0
    count: int = 1
    arg: float = 0.0
    ladder: int = 1

    def __post_init__(self):
        if self.seam not in FAULT_SEAMS:
            raise ValueError(f"unknown fault seam {self.seam!r} (have {FAULT_SEAMS})")

    def due(self, index: int, fired: int) -> bool:
        if fired >= self.count or index < self.at:
            return False
        if index == self.at:
            return True
        return self.every > 0 and (index - self.at) % self.every == 0

    def to_dict(self) -> dict:
        return {"seam": self.seam, "at": self.at, "every": self.every, "count": self.count, "arg": self.arg, "ladder": self.ladder}


@dataclass(frozen=True)
class FaultSpec:
    """A seeded, deterministic fault plan (tuple of FaultRule). Serializes
    to/from a plain dict so it rides the ChurnHarness JSONL log header."""

    rules: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    def to_dict(self) -> dict:
        return {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(rules=tuple(FaultRule(**r) for r in d.get("rules", ())), seed=int(d.get("seed", 0)))

    @classmethod
    def randomized(cls, seed: int, solves: int = 20, events: int = 1000, cycles: int = 8) -> "FaultSpec":
        """A randomized-but-seeded chaos plan across every seam, scaled to
        the run's expected solve/event/cycle counts (the chaos-soak spec's
        input). The plan stays SURVIVABLE by construction: solver faults are
        recoverable (ladder <= 2) and revocations reclaim one node at a
        time, so a no-fault run of the same event stream must converge to
        the same placements."""
        rng = random.Random(seed)
        rules = [
            FaultRule("solve-exception", at=rng.randrange(max(1, solves // 4), max(2, solves // 2)), ladder=rng.choice((1, 1, 2))),
            FaultRule("decode-failure", at=rng.randrange(max(1, solves // 2), max(2, solves)), ladder=1),
            FaultRule("watch-drop", at=rng.randrange(0, max(1, events // 2)), every=max(7, events // 11), count=rng.randrange(2, 6)),
            FaultRule("watch-dup", at=rng.randrange(0, max(1, events // 2)), every=max(5, events // 13), count=rng.randrange(2, 6)),
            FaultRule("watch-reorder", at=rng.randrange(0, max(1, events // 2)), every=max(11, events // 7), count=rng.randrange(2, 5)),
            FaultRule("prestage-death", at=rng.randrange(0, 3), count=1),
            FaultRule("revocation", at=rng.randrange(1, max(2, cycles)), count=1, arg=1),
        ]
        return cls(rules=tuple(rules), seed=seed)


class FaultInjector:
    """The runtime half of a FaultSpec: installed at the named seams
    (solver.fault_hook, Store.set_fault_injector, PendingPrestager
    .fault_hook, ChurnHarness.take_revocations) and consulted with per-seam
    monotone indices. Thread-safe: seam calls arrive from the solve thread,
    watch-delivery threads, and the prestager worker concurrently."""

    # racecheck guarded-field registry: indices/fired counts are bumped from
    # multiple threads (watch delivery vs solve vs worker)
    GUARDED_FIELDS = {
        "_indices": "_lock",
        "_fired": "_lock",
        "_armed_depth": "_lock",
        "_deferred": "_lock",
        "injected": "_lock",
        "log": "_lock",
    }

    def __init__(self, spec: FaultSpec, registry=None):
        self.spec = spec
        self.registry = registry
        self.rng = random.Random(spec.seed)
        self._lock = make_lock("faults")
        self._indices: dict[str, int] = {"solve": 0, "watch": 0, "prestage": 0, "cycle": 0}
        self._fired: list[int] = [0] * len(spec.rules)
        # ladder stages left to poison within the CURRENT solve (armed by a
        # solve-seam firing with ladder > 1, consumed by the recovery hook)
        self._armed_depth = 0
        # the watch-reorder hold slot (at most one event deferred at a time)
        self._deferred: list = []
        self.injected: dict[str, int] = {}
        self.log: list[dict] = []

    # -- bookkeeping -----------------------------------------------------------
    def _fire(self, ri: int, rule: FaultRule, index: int, unit: str) -> None:  # solverlint: ok(guarded-field-access): caller-holds contract — every call site sits inside `with self._lock` (solver_hook / on_watch_event / prestage_hook / take_revocations)
        self._fired[ri] += 1
        touch(self, "injected")
        self.injected[rule.seam] = self.injected.get(rule.seam, 0) + 1
        self.log.append({"seam": rule.seam, unit: index})

    def _emit(self, seam: str, n: float = 1) -> None:
        # metric emission OUTSIDE the injector lock (metric locks are leaves,
        # but the injector must never hold its lock across foreign code)
        if self.registry is not None:
            from ..metrics import SOLVER_FAULT_INJECTIONS_TOTAL

            self.registry.counter(SOLVER_FAULT_INJECTIONS_TOTAL).inc(n, seam=seam)  # solverlint: ok(metric-label-cardinality): seam is a FaultRule.seam validated against the static FAULT_SEAMS enum at construction

    def summary(self) -> dict:
        with self._lock:
            return dict(self.injected)

    # -- the solver seam (GPUSolver.fault_hook) --------------------------------
    def solver_hook(self, stage: str = "solve") -> None:
        """`stage="solve"`: the solve-attempt seam (indexed per solve).
        `stage="reencode"`: the degradation ladder's re-encode retry — fires
        only while a ladder>1 solve fault left poison armed."""
        if stage == "reencode":
            with self._lock:
                armed = self._armed_depth > 0
                if armed:
                    self._armed_depth -= 1
            if armed:
                raise FaultInjected("faultline: injected re-encode failure", seam="solve-exception")
            return
        fired_rule = None
        with self._lock:
            i = self._indices["solve"]
            self._indices["solve"] = i + 1
            for ri, rule in enumerate(self.spec.rules):
                if rule.seam in _SOLVE_SEAMS and rule.due(i, self._fired[ri]):
                    self._fire(ri, rule, i, "solve")
                    if rule.seam != "slow-solve":
                        self._armed_depth = max(0, int(rule.ladder) - 1)
                    fired_rule = rule
                    break
        if fired_rule is None:
            return
        self._emit(fired_rule.seam)
        if fired_rule.seam == "slow-solve":
            time.sleep(fired_rule.arg or 0.05)
            return
        unrecoverable = int(fired_rule.ladder) <= 0
        if fired_rule.seam == "decode-failure":
            raise FaultInjected(
                "faultline: injected decode-validation failure", seam="decode-failure", unrecoverable=unrecoverable
            )
        raise FaultInjected("faultline: injected solve exception", seam="solve-exception", unrecoverable=unrecoverable)

    # -- the watch-stream seam (Store._drain) ----------------------------------
    def on_watch_event(self, event: str, obj, t_commit: float, seq: int = 0) -> list:
        """Transform one about-to-be-delivered Pod event into the list of
        events actually delivered: `[]` (drop / deferred for reorder), the
        event twice (dup), or the event followed by a previously deferred
        one (the reorder swap: the OLDER event arrives after its successor).
        `seq` is the store's per-kind delivery sequence number — it travels
        with the event untouched, so the store's gap tracker sees exactly
        what a lossy stream's consumer would (a dropped seq never arrives,
        a dup arrives twice, a reorder arrives late)."""
        fired = None
        out: list = [(event, obj, t_commit, seq)]
        with self._lock:
            i = self._indices["watch"]
            self._indices["watch"] = i + 1
            for ri, rule in enumerate(self.spec.rules):
                if rule.seam in _WATCH_SEAMS and rule.due(i, self._fired[ri]):
                    self._fire(ri, rule, i, "event")
                    fired = rule.seam
                    break
            if fired == "watch-drop":
                out = []
            elif fired == "watch-dup":
                out = [(event, obj, t_commit, seq), (event, obj, t_commit, seq)]
            elif fired == "watch-reorder":
                touch(self, "_deferred")
                self._deferred.append((event, obj, t_commit, seq))
                out = []
            elif self._deferred:
                # the reorder swap completes: successor first, deferred after
                out = out + self._deferred
                self._deferred = []
        if fired is not None:
            self._emit(fired)
        return out

    def take_deferred(self):
        """Drain one reorder-deferred event once the store queue empties, so
        a reorder at the tail of a burst delays delivery, never loses it."""
        with self._lock:
            if not self._deferred:
                return None
            touch(self, "_deferred")
            return self._deferred.pop(0)

    # -- the prestager seam (PendingPrestager.fault_hook) ----------------------
    def prestage_hook(self) -> None:
        """Called per worker loop iteration; a due prestage-death rule kills
        the worker thread (SystemExit exits the thread silently — exactly
        the no-signal death the supervisor must detect and restart)."""
        fire = False
        with self._lock:
            i = self._indices["prestage"]
            self._indices["prestage"] = i + 1
            for ri, rule in enumerate(self.spec.rules):
                if rule.seam == "prestage-death" and rule.due(i, self._fired[ri]):
                    self._fire(ri, rule, i, "iteration")
                    fire = True
                    break
        if fire:
            self._emit("prestage-death")
            raise SystemExit("faultline: injected prestager worker death")

    # -- the revocation seam (ChurnHarness cycle boundary) ---------------------
    def take_revocations(self) -> int:
        """Nodes to revoke this churn cycle (consumes due revocation rules;
        indexed per cycle). The harness decodes them as forced departures."""
        n = 0
        with self._lock:
            i = self._indices["cycle"]
            self._indices["cycle"] = i + 1
            for ri, rule in enumerate(self.spec.rules):
                if rule.seam == "revocation" and rule.due(i, self._fired[ri]):
                    self._fire(ri, rule, i, "cycle")
                    nodes = max(1, int(rule.arg))
                    # the injected tally counts NODES revoked, not firings
                    self.injected["revocation"] += nodes - 1
                    n += nodes
        if n:
            self._emit("revocation", n)
        return n


class CircuitBreaker:
    """Per-tenant circuit breaker for the fleet dispatch seam.

    States (the bounded TENANT_STATES enum): `healthy` -> after K
    consecutive failures -> `quarantined` (no dispatch; the fleet keeps
    serving everyone else) -> once the backoff elapses, `allow()` admits ONE
    half-open `probing` dispatch -> success closes it (`healthy`, backoff
    reset), failure re-quarantines with the backoff DOUBLED (capped).
    `now_fn` defaults to time.monotonic; deterministic drivers inject a fake
    clock's now."""

    # racecheck guarded-field registry: the pump loop mutates, /debug/tenants
    # HTTP workers read — every touch under the breaker's leaf lock
    GUARDED_FIELDS = {
        "state": "_lock",
        "consecutive": "_lock",
        "opens": "_lock",
        "probes": "_lock",
        "opened_at": "_lock",
        "backoff": "_lock",
        "last_error": "_lock",
    }

    def __init__(self, failures_to_open: int = 3, backoff_seconds: float = 0.5, backoff_max: float = 30.0, now_fn=None):
        self._lock = make_lock("breaker")
        self.now = now_fn if now_fn is not None else time.monotonic
        self.failures_to_open = max(1, int(failures_to_open))
        self.backoff_base = float(backoff_seconds)
        self.backoff_max = float(backoff_max)
        self.state = "healthy"
        self.consecutive = 0
        self.opens = 0  # total quarantine episodes
        self.probes = 0  # half-open probes dispatched
        self.opened_at = 0.0
        self.backoff = self.backoff_base
        self.last_error = ""

    def allow(self) -> bool:
        """May a solve dispatch now? Transitions quarantined -> probing when
        the backoff has elapsed (admitting exactly one probe)."""
        with self._lock:
            if self.state == "healthy":
                return True
            if self.state == "quarantined" and (self.now() - self.opened_at) >= self.backoff:
                touch(self, "state")
                self.state = "probing"
                self.probes += 1
                return True
            return False

    def record_success(self) -> bool:
        """A dispatched solve succeeded. Returns True when this re-admitted
        a quarantined/probing tenant (the caller publishes the transition)."""
        with self._lock:
            self.consecutive = 0
            if self.state != "healthy":
                touch(self, "state")
                self.state = "healthy"
                self.backoff = self.backoff_base
                self.last_error = ""
                return True
            return False

    def record_failure(self, err: object = "") -> str | None:
        """A dispatched solve raised. Returns the new state when this opened
        (or re-opened) the breaker, else None. A probe failure doubles the
        backoff (capped); K consecutive failures open from healthy."""
        with self._lock:
            self.consecutive += 1
            self.last_error = f"{type(err).__name__}: {err}"[:200] if isinstance(err, BaseException) else str(err)[:200]
            if self.state == "probing":
                touch(self, "state")
                self.state = "quarantined"
                self.opens += 1
                self.opened_at = self.now()
                self.backoff = min(self.backoff_max, self.backoff * 2.0)
                return "quarantined"
            if self.state == "healthy" and self.consecutive >= self.failures_to_open:
                touch(self, "state")
                self.state = "quarantined"
                self.opens += 1
                self.opened_at = self.now()
                self.backoff = self.backoff_base
                return "quarantined"
            return None

    def probe_inconclusive(self) -> None:
        """The admitted probe never produced a verdict (e.g. the reconcile
        declined to solve): re-quarantine WITHOUT doubling, so the next
        backoff window admits another probe instead of wedging in probing."""
        with self._lock:
            if self.state == "probing":
                touch(self, "state")
                self.state = "quarantined"
                self.opened_at = self.now()

    def state_name(self) -> str:
        with self._lock:
            return self.state

    def remaining_backoff(self) -> float:
        """Seconds until a quarantined tenant's next probe window (0 when
        dispatchable) — the fleet serve loop folds this into its sleep."""
        with self._lock:
            if self.state != "quarantined":
                return 0.0
            return max(0.0, self.backoff - (self.now() - self.opened_at))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive,
                "opens": self.opens,
                "probes": self.probes,
                "backoff_seconds": round(self.backoff, 3),
                "last_error": self.last_error,
            }
