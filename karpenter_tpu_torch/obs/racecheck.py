"""racecheck: the runtime arm of the concurrency sanitizer.

The serving stack is a handful of long-lived threads (prestager worker,
churn driver, store watch delivery, operator HTTP server, leader-election
renewer) coordinating through a small set of named locks. The static arm
(`analysis/rules.py`: guarded-field-access, lock-order, thread-escape,
bare-thread-primitive) proves what it can from source; this module enforces
the rest at runtime, the way Go's race detector backs up "fields guarded by
mu" comments:

- every lock in the stack is constructed through `make_lock`/`make_rlock`
  (the bare-thread-primitive rule pins that), so under
  ``KARPENTER_SOLVER_RACECHECK=1`` every acquisition is observed;
- the DYNAMIC lock-order graph is recorded per acquisition edge (lock A held
  while acquiring lock B); an edge that closes a cycle raises
  `RaceCheckError` at the acquisition site — a potential deadlock caught the
  first time the inverted order executes, not the first time it interleaves;
- guarded-field touch points call `touch(obj, field)`: a cheap owner-thread
  check that the field's declared lock (the class's ``GUARDED_FIELDS``
  registry, which the static rule also reads) is held by the current thread;
- lock WAIT time feeds the ``karpenter_solver_lock_wait_seconds{lock}``
  histogram (contention observability), and HOLD times above
  ``KARPENTER_RACECHECK_HOLD_OUTLIER`` seconds are recorded as outliers —
  a lock held across a solve or a device sync shows up here even when no
  inversion ever fires.

With the env var off, `make_lock`/`make_rlock` return the plain
`threading.Lock`/`RLock` objects — bit-identical behavior, zero overhead
(tests pin this parity). Lock NAMES are a small static enum (one name per
lock class, like Go lock ranking): same-name locks on different instances
share a graph node, which is exactly what makes cross-instance order
violations visible.
"""

from __future__ import annotations

import os
import threading
import time
import weakref

# this module IS the sanctioned wrapper the bare-thread-primitive rule
# points at; it necessarily constructs raw primitives itself
_LOCK_CLS = type(threading.Lock())

_ENABLED: bool | None = None


def racecheck_enabled() -> bool:
    """Cached read of KARPENTER_SOLVER_RACECHECK (call `_refresh()` after
    changing the env var mid-process, e.g. in tests)."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("KARPENTER_SOLVER_RACECHECK", "").strip().lower() in ("1", "true", "on")
    return _ENABLED


def _refresh() -> None:
    global _ENABLED
    _ENABLED = None


class RaceCheckError(AssertionError):
    """A concurrency-discipline violation: lock-order inversion, a guarded
    field touched without its lock, or a non-reentrant relock."""


# per-thread state: the stack of InstrumentedLocks currently held, plus a
# reentrancy guard so metric emission from inside the instrumentation never
# re-enters the bookkeeping
_tls = threading.local()


class _Global:
    """Process-wide sanitizer state. Guarded by its own PLAIN lock — the one
    lock in the stack that is deliberately uninstrumented (it nests inside
    every instrumented acquisition and never calls out)."""

    def __init__(self):
        self.lock = threading.Lock()
        # (a, b): lock named `a` was held while acquiring `b`; value = first
        # observation "thread-name file-agnostic description"
        self.edges: dict[tuple[str, str], str] = {}
        self.adj: dict[str, set[str]] = {}
        self.violations: list[str] = []
        self.wait: dict[str, list[float]] = {}  # name -> [count, total, max]
        self.hold_outliers: list[tuple[str, float, str]] = []
        self.touch_checks = 0
        self.registry_ref = None  # weakref: see set_metrics_registry

    def clear(self) -> None:
        self.edges.clear()
        self.adj.clear()
        self.violations.clear()
        self.wait.clear()
        self.hold_outliers.clear()
        self.touch_checks = 0


_G = _Global()

_HOLD_OUTLIER_SECONDS = float(os.environ.get("KARPENTER_RACECHECK_HOLD_OUTLIER", "0.25"))
_MAX_OUTLIERS = 256


def set_metrics_registry(registry) -> None:
    """Install the registry the wait-time histogram is emitted to (the
    operator Environment does this when racecheck is enabled).

    Process-global, last-writer-wins — a production process runs ONE
    Environment; in a multi-env test process the newest install receives
    the emissions. Held by WEAK reference so a torn-down Environment's
    registry is released (emissions just stop) instead of being pinned
    alive by the sanitizer forever."""
    _G.registry_ref = weakref.ref(registry) if registry is not None else None


def reset() -> None:
    """Drop the recorded graph/stats (test isolation). Held-lock state is
    per-thread and survives — only call between quiesced phases."""
    with _G.lock:
        _G.clear()


def snapshot() -> dict:
    """A copy of the sanitizer's observations for tests and debugging."""
    with _G.lock:
        return {
            "edges": dict(_G.edges),
            "violations": list(_G.violations),
            "wait": {k: tuple(v) for k, v in _G.wait.items()},
            "hold_outliers": list(_G.hold_outliers),
            "touch_checks": _G.touch_checks,
        }


def _held_stack() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _reaches(adj: dict[str, set[str]], src: str, dst: str) -> bool:
    """DFS reachability over the tiny (≤ #lock names) order graph."""
    stack, seen = [src], {src}
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        for nxt in adj.get(n, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def _record_edges(held: list, name: str) -> None:
    """Record (held -> name) for every currently-held lock; raise on any edge
    that closes a cycle (the full cycle check, not just pairwise inversion —
    a→b, b→c, c→a never shows a directly reversed edge)."""
    if not held:
        return
    me = threading.current_thread().name
    with _G.lock:
        for h in held:
            a = h.name
            if a == name or (a, name) in _G.edges:
                continue
            if _reaches(_G.adj, name, a):
                first = _G.edges.get((name, a)) or next(
                    (w for (x, _y), w in _G.edges.items() if x == name), "?"
                )
                msg = (
                    f"lock-order inversion: thread {me!r} acquires {name!r} while holding {a!r}, "
                    f"but the order {name!r} -> ... -> {a!r} was already observed ({first})"
                )
                _G.violations.append(msg)
                raise RaceCheckError(msg)
            _G.edges[(a, name)] = f"thread {me}"
            _G.adj.setdefault(a, set()).add(name)


def _record_wait(name: str, seconds: float) -> None:
    with _G.lock:
        stats = _G.wait.setdefault(name, [0.0, 0.0, 0.0])
        stats[0] += 1
        stats[1] += seconds
        if seconds > stats[2]:
            stats[2] = seconds
    registry = _G.registry_ref() if _G.registry_ref is not None else None
    if registry is not None and not getattr(_tls, "busy", False):
        _tls.busy = True  # metric locks are instrumented too: don't recurse
        try:
            from ..metrics import SOLVER_LOCK_WAIT_BUCKETS, SOLVER_LOCK_WAIT_SECONDS

            registry.histogram(
                SOLVER_LOCK_WAIT_SECONDS,
                "Time spent waiting to acquire a named serving-stack lock (racecheck wrapper)",
                ("lock",),
                SOLVER_LOCK_WAIT_BUCKETS,
            ).observe(seconds, lock=name)  # solverlint: ok(metric-label-cardinality): lock names are the static make_lock call-site literals — an enum the bare-thread-primitive rule keeps closed
        except Exception as e:  # noqa: BLE001  # solverlint: ok(swallowed-exception): recorded into _G.violations below — surfaced as a sanitizer violation, never a leaked lock
            # an emission failure mid-acquire would otherwise propagate out
            # of acquire() with the lock held but `with` never entered —
            # surface it as a violation instead of a leaked lock
            with _G.lock:
                _G.violations.append(f"lock-wait metric emission failed for {name!r}: {e!r}")
        finally:
            _tls.busy = False


class InstrumentedLock:
    """Drop-in for threading.Lock/RLock recording order edges, wait time,
    hold-time outliers, and the owner thread (for `touch` / `held_by_me`)."""

    __slots__ = ("name", "reentrant", "_lock", "_owner", "_count", "_acquired_at")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._owner: int | None = None
        self._count = 0
        self._acquired_at = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:
            if not self.reentrant:
                # a plain Lock would deadlock silently here; fail loudly
                raise RaceCheckError(f"non-reentrant lock {self.name!r} re-acquired by its owner thread")
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                self._count += 1
            return ok
        if getattr(_tls, "busy", False):  # inside our own metric emission
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                self._owner, self._count, self._acquired_at = me, 1, time.perf_counter()
            return ok
        held = _held_stack()
        _record_edges(held, self.name)
        t0 = time.perf_counter()
        ok = self._lock.acquire(blocking, timeout)
        if not ok:
            return False
        now = time.perf_counter()
        self._owner, self._count, self._acquired_at = me, 1, now
        held.append(self)
        _record_wait(self.name, now - t0)
        return True

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner != me:
            raise RaceCheckError(f"lock {self.name!r} released by thread {me} which does not own it")
        self._count -= 1
        if self._count == 0:
            hold = time.perf_counter() - self._acquired_at
            if hold > _HOLD_OUTLIER_SECONDS:
                with _G.lock:
                    if len(_G.hold_outliers) < _MAX_OUTLIERS:
                        _G.hold_outliers.append((self.name, hold, threading.current_thread().name))
            self._owner = None
            held = getattr(_tls, "held", None)
            if held:
                if held[-1] is self:
                    held.pop()
                elif self in held:  # out-of-order release: tolerated, still tracked
                    held.remove(self)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    @property
    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._owner is not None


# -- the sanctioned constructors (what bare-thread-primitive points at) -------
def make_lock(name: str):
    """A mutex for the named lock class. Plain `threading.Lock` when the
    sanitizer is off; instrumented when KARPENTER_SOLVER_RACECHECK=1."""
    return InstrumentedLock(name, reentrant=False) if racecheck_enabled() else threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of `make_lock` (same-thread re-acquisition is legal
    and recorded without an order edge)."""
    return InstrumentedLock(name, reentrant=True) if racecheck_enabled() else threading.RLock()


def make_event() -> threading.Event:
    """Events are inherently thread-safe; routed through here so the
    bare-thread-primitive rule keeps one inventory of every primitive."""
    return threading.Event()


def spawn_thread(target, name: str | None = None, args: tuple = (), daemon: bool = True) -> threading.Thread:
    """Construct AND start a worker thread. The thread-escape rule requires
    `target` to be in the declared thread-shared registry, so every entry
    point into concurrent execution is a reviewed, named seam."""
    t = threading.Thread(target=target, name=name, args=args, daemon=daemon)
    t.start()
    return t


def touch(obj, field: str) -> None:
    """Assert `obj`'s declared guard for `field` is held by this thread.

    The declared touch points (stat counters and caches named in a class's
    GUARDED_FIELDS registry) call this on their mutation paths; a touch
    without the lock raises `RaceCheckError` under the sanitizer and costs
    one cached-bool check when it is off."""
    if not racecheck_enabled():
        return
    guards = getattr(type(obj), "GUARDED_FIELDS", None)
    if not guards or field not in guards:
        raise RaceCheckError(f"{type(obj).__name__}.{field} touched but not declared in GUARDED_FIELDS")
    lk = getattr(obj, guards[field], None)
    # debug stat only read by snapshot(): deliberately approximate — the
    # unsynchronized += can lose an increment under contention, which is
    # fine for a did-any-touch-run indicator, while taking _G.lock here
    # would serialize every touch point across all threads and skew the
    # very contention numbers the sanitizer reports
    _G.touch_checks += 1
    if isinstance(lk, InstrumentedLock) and not lk.held_by_me:
        msg = f"guarded field {type(obj).__name__}.{field} touched without holding {guards[field]!r}"
        with _G.lock:
            _G.violations.append(msg)
        raise RaceCheckError(msg)
