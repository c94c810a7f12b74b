"""Pod batcher: idle/max windows (reference: provisioning/batcher.go:33-110)
plus in-flight-aware wake-up coalescing for the steady-state serving loop.

Triggers accumulate; a batch fires after BatchIdleDuration of quiet or
BatchMaxDuration since the first trigger (defaults 1s/10s, options.go:129-130).

Coalescing (the churn serving loop's throughput lever): triggers that arrive
WHILE a solve is in flight fold into one pending generation instead of each
scheduling work — when the solve completes, `ready()` fires immediately
(the in-flight solve itself WAS the batching window, so the accumulated
generation drains as ONE batched follow-up solve with no idle-window stall).
N triggers during a solve therefore cost exactly one follow-up solve, never
N. The provisioner brackets its solve with `begin_solve()`/`end_solve()`;
a batcher that never sees those calls behaves exactly like the reference's
idle/max-window batcher.

Thread-safe: triggers arrive from store watch callbacks on whatever thread
mutated the store (the serving harness's event driver runs concurrently
with the solve loop), so the trigger/bracket state is lock-guarded — a
trigger racing `end_solve`'s read-and-zero must either land in the returned
coalesced count or in the next generation, never vanish.
"""

from __future__ import annotations

import time

from ...obs.racecheck import make_lock


class Batcher:
    # racecheck guarded-field registry: the trigger/bracket state is written
    # from watch-delivery threads and read by the serving loop — every touch
    # goes through `_lock` (analysis: guarded-field-access enforces it)
    GUARDED_FIELDS = {
        "_first": "_lock",
        "_last": "_lock",
        "_count": "_lock",
        "_in_flight": "_lock",
        "_during": "_lock",
        "_drain": "_lock",
        "_opened_monotonic": "_lock",
        "_last_gen": "_lock",
    }

    def __init__(self, clock, idle_seconds: float = 1.0, max_seconds: float = 10.0):
        self.clock = clock
        self.idle = idle_seconds
        self.max = max_seconds
        self._lock = make_lock("batcher")
        self._first: float | None = None
        self._last: float | None = None
        # current generation's trigger count (the solve-queue depth surface)
        self._count = 0
        # in-flight coalescing state
        self._in_flight = False
        self._during = 0  # triggers folded into the in-flight solve's window
        self._drain = False  # a coalesced generation is waiting: fire now
        # podtrace: MONOTONIC open stamp of the pending generation and the
        # last taken generation's window summary (opened -> taken residency
        # + trigger count) — the coalescing-window surface the event tracer
        # links into each solve's event-batch note. The fake-clock fields
        # above drive window POLICY; these measure wall residency.
        self._opened_monotonic = 0.0
        self._last_gen: dict | None = None
        # push-wake seam (serving/fleet.py): a zero-arg callable invoked on
        # every trigger, AFTER the lock is released — the fleet front-end
        # installs one per tenant to mark the tenant runnable and wake the
        # fleet loop, so a watch-delivered arrival reaches the scheduler
        # push-style instead of waiting for the next poll of ready(). The
        # hook must be cheap and lock-ordered BELOW the batcher lock (the
        # fleet's wake path takes only its own leaf lock + an Event.set).
        self.wake_hook = None

    def trigger(self, uid: str = "") -> None:
        now = self.clock.now()
        with self._lock:
            if self._first is None:
                self._first = now
                self._opened_monotonic = time.monotonic()
            self._last = now
            self._count += 1
            if self._in_flight:
                self._during += 1
        hook = self.wake_hook
        if hook is not None:
            hook()

    # -- in-flight coalescing (serving loop) -----------------------------------
    def take_generation(self) -> int:
        """Atomically close the current generation AND open the in-flight
        window (reset + begin_solve in one lock hold): returns the closed
        generation's trigger count. A concurrent trigger either lands in the
        returned count or in the in-flight window — never in a gap between
        the two, which would erase it from the coalescing accounting and
        cost its follow-up solve a full idle-window stall."""
        with self._lock:
            n = self._count
            taken = time.monotonic()
            self._last_gen = {
                "count": n,
                "window_s": max(0.0, taken - self._opened_monotonic) if n else 0.0,
                "taken_monotonic": taken,
            }
            self._first = None
            self._last = None
            self._count = 0
            self._drain = False
            self._in_flight = True
            self._during = 0
            return n

    def last_generation(self) -> dict | None:
        """The most recently taken generation's wall-clock window summary
        ({count, window_s, taken_monotonic}) — the coalescing-residency
        surface podtrace joins into the solve's event-batch note."""
        with self._lock:
            return dict(self._last_gen) if self._last_gen is not None else None

    def begin_solve(self) -> None:
        """The provisioner is entering a solve: triggers from here to
        `end_solve()` coalesce into one pending generation."""
        with self._lock:
            self._in_flight = True
            self._during = 0

    def end_solve(self) -> int:
        """The solve finished. Returns the number of triggers coalesced into
        the pending generation and, when nonzero, arms the drain so the next
        `ready()` fires immediately — one batched follow-up solve."""
        with self._lock:
            self._in_flight = False
            n, self._during = self._during, 0
            if n:
                self._drain = True
            return n

    def pending(self) -> int:
        """Triggers accumulated in the current (unfired) generation."""
        with self._lock:
            return self._count

    def eta(self) -> float | None:
        """Seconds until `ready()` would fire for the pending generation
        (0.0 = ready now), or None when no generation is open. The fleet
        front-end's push loop sleeps exactly this long instead of polling:
        the idle/max window stays a COALESCING bound while the poll interval
        stops being a latency floor."""
        now = self.clock.now()
        with self._lock:
            if self._first is None:
                return None
            if self._drain:
                return 0.0
            return max(0.0, min(self._last + self.idle, self._first + self.max) - now)

    def ready(self) -> bool:
        now = self.clock.now()
        with self._lock:
            if self._first is None:
                return False
            if self._drain:
                # coalesced generation: the just-finished solve was the window
                return True
            return (now - self._last) >= self.idle or (now - self._first) >= self.max

    def reset(self) -> None:
        with self._lock:
            self._first = None
            self._last = None
            self._count = 0
            self._drain = False
