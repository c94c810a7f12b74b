"""ServingLoop: the steady-state solve pump around a live Provisioner.

One `pump()` is one serving iteration: run the provisioner's reconcile if
its batcher window (or a coalesced drain generation) is ready, then the
caller-supplied post-solve controllers (lifecycle/binder/... — whatever the
deployment runs between solves). The loop itself adds no policy beyond
wiring the two serving-mode mechanisms in:

- wake-up coalescing lives in the Batcher (begin_solve/end_solve bracket,
  installed by Provisioner.reconcile): triggers arriving during an in-flight
  solve fold into ONE batched follow-up solve, which `pump` picks up on its
  next call with no idle-window stall;
- double-buffering lives in the PendingPrestager, installed here: the next
  batch's host-side clone+stamp work overlaps the current device pack on a
  worker thread (KARPENTER_SOLVER_DOUBLEBUF=0 disables — clones rebuilt per
  pass, restoring the pre-serving-loop provisioner behavior exactly);
- event-lifecycle observability rides the same wiring (obs/podtrace.py):
  the Environment installs one PodTracer on the store's delivery seam and
  the provisioner, and `PendingPrestager.attach` adopts it for its
  staged-vs-missed stamps — so every pump here closes the
  arrival -> coalesce -> [sched-wait] -> solve legs of the per-event trace
  without the loop itself holding any tracer state.

None of these mechanisms may change placements: tests pin bit-identical
results against serial one-solve-per-batch execution with the hatches off
and with podtrace disabled.
"""

from __future__ import annotations

import os

from .prestage import PendingPrestager


def doublebuf_enabled() -> bool:
    return os.environ.get("KARPENTER_SOLVER_DOUBLEBUF", "1").strip().lower() not in ("0", "false", "off")


class ServingLoop:
    def __init__(self, provisioner, store, double_buffer: bool | None = None, post_solve=(), worker: bool = True):
        """`post_solve`: zero-arg callables run after every successful solve
        (in order). `worker=False` keeps the prestager synchronous (its queue
        drains via `prestager.pump()`/take-miss fills) for deterministic
        single-threaded runs — same results, no overlap."""
        self.provisioner = provisioner
        self.post_solve = list(post_solve)
        self.double_buffer = doublebuf_enabled() if double_buffer is None else bool(double_buffer)
        self.solves = 0
        self.prestager: PendingPrestager | None = None
        if self.double_buffer:
            self.prestager = PendingPrestager()
            self.prestager.attach(store)
            self.prestager.metrics = provisioner.metrics
            provisioner.prestager = self.prestager
            if worker:
                self.prestager.start()

    def pump(self, force: bool = False):
        """One serving iteration. Returns the solve's Results or None when
        the batcher window has not closed."""
        if self.prestager is not None:
            # supervision (faultline): a worker thread that DIED (injected
            # fault or real crash) is restarted here — detected and counted,
            # never a silent permanent downgrade to synchronous prep
            self.prestager.ensure_worker()
            if not self.prestager.worker_alive():
                self.prestager.pump()  # synchronous mode: drain before the solve
        results = self.provisioner.reconcile(force=force)
        if results is not None:
            self.solves += 1
            for fn in self.post_solve:
                fn()
        return results

    def drain(self, max_solves: int = 64) -> int:
        """Pump until the batcher goes quiet (coalesced generations included);
        returns the number of solves run."""
        n = 0
        while n < max_solves and self.provisioner.batcher.ready():
            if self.pump() is None:
                break
            n += 1
        return n

    def close(self) -> None:
        if self.prestager is not None:
            self.prestager.stop()
            self.provisioner.prestager = None
            self.prestager = None
