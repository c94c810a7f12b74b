"""PendingPrestager: the serving loop's double buffer for host-side encode
prep.

The solver's hot path is one fused device->host landing (enforced by
solverlint), so while a pack is executing on device the host thread is
blocked in that landing and the host CPU is otherwise idle. The next solve's
host-side work, however, is already known: every pod that triggered the
batcher during the in-flight solve will be in the next batch, and its
per-pod encode prep — the snapshot clone `get_pending_pods` must make, the
PVC validation verdict, and the signature stamp (`encode._batch_stamp`) —
is a pure function of the pod's content. The prestager runs that prep on a
worker thread concurrently with the pack, so by the time the coalesced
follow-up solve drains, its batch is already cloned and stamped.

Clone identity is the second effect: the cache hands out the SAME clone
object for a pod while its (uid, resourceVersion) is unchanged.
`encode._try_delta_encode` walks the previous solve's pod list by OBJECT
identity — with per-pass fresh clones (the pre-serving behavior) no pod
matches and every surviving pod classifies as removed-and-re-added, so the
"delta" degenerates to a full remove-all/add-all turnover (admissible since
the cap widened, but it re-credits and re-packs the entire backlog every
solve). With the prestager, a pod pending across two solves IS the same
object and the delta is exactly the true arrivals/cancellations.

The decode-delta memo (`GPUSolver._decode`) leans on the same contract from
the other end: a reused slot hands back the PRIOR decode's claim built over
the prior solve's pod objects, and its correctness argument — "slot count
unchanged + no assignment row touched it ⇒ identical member set" — holds
because an unchanged pod ((uid, resourceVersion) stable) is the same clone
in both solves. A pod whose content changed gets a NEW clone here, which
re-keys its encode signature and moves its assignment row, so the decode
marks every slot it touches dirty and re-materializes them; clone identity
is what makes "row untouched" equivalent to "membership unchanged".

Safety:
- Clones are never mutated by a solve: the host scheduler deep-copies a pod
  before its first preference relaxation and leaves the caller's object
  pristine (scheduler._try_schedule), and the tensor path only reads.
- Only pods without claim-backed volumes are staged (`take` returns None for
  the rest): their PVC validation verdict depends on store content the
  (uid, rv) key cannot see, and their signatures extend with resolved volume
  components only the sequential encode path builds.
- Worker-thread writes are private until published under the lock; signature
  stamping/interning is the same idempotent content-addressed work the
  encode would do, so a race between worker and an in-flight encode is at
  worst duplicated effort, never a different placement.
"""

from __future__ import annotations

from collections import deque

from ..kube.clone import fast_deepcopy
from ..obs.racecheck import make_event, make_lock, spawn_thread, touch
from ..utils import pods as pod_utils

_MAX_ENTRIES = 500_000  # hard bound; a clear just re-stages on demand


def _stampable(pod) -> bool:
    from ..solver.volumes import has_pvc_volumes

    return not has_pvc_volumes(pod)


def _rv_newer(a, b) -> bool:
    """True when resource_version `a` is strictly newer than `b`. Store RVs
    are monotone ints; non-int doubles fall back to inequality (any change
    counts as newer — at worst a redundant restage, never a stale keep)."""
    try:
        return int(a) > int(b)
    except (TypeError, ValueError):
        return a != b


class PendingPrestager:
    """(uid -> (resourceVersion, clone)) cache of pre-staged pending pods,
    filled by a worker thread (double-buffer mode) and authoritatively on
    `take` misses, evicted by store watch events (bind/delete)."""

    # racecheck guarded-field registry (analysis: guarded-field-access;
    # runtime: obs.racecheck.touch at the stat increments). The cache AND
    # the stat counters are written by the worker thread and the solve
    # thread concurrently; `_queue` is deliberately absent — deque
    # append/popleft are atomic and the queue is single-consumer.
    GUARDED_FIELDS = {
        "_cache": "_lock",
        "_thread": "_lock",
        "_stop": "_lock",
        "_worker_wanted": "_lock",
        "staged": "_lock",
        "reused": "_lock",
        "misses": "_lock",
        "restarts": "_lock",
    }

    def __init__(self):
        self._lock = make_lock("prestage")
        self._cache: dict[str, tuple[str, object]] = {}
        self._queue: deque = deque()
        self._wake = make_event()
        self._stop = make_event()
        self._thread = None
        # podtrace (obs/podtrace.py): staged-vs-missed stamps per event —
        # adopted from the attached store's delivery seam; the tracer's own
        # lock guards its state, so stamping needs no prestage lock
        self.podtracer = None
        # stats (read by the churn harness/loop for attribution), guarded by
        # _lock like the cache they describe
        self.staged = 0  # clones prepared by the worker ahead of a take
        self.reused = 0  # takes served by an existing clone (delta identity)
        self.misses = 0  # takes that cloned inline (arrived un-staged)
        # supervision (faultline): start() records that a worker is WANTED;
        # ensure_worker() restarts a dead-but-wanted worker and counts it —
        # before this, a worker death silently degraded every later solve to
        # synchronous prep with no signal
        self._worker_wanted = False
        self.restarts = 0
        # metrics registry for the restart counter (installed by ServingLoop)
        self.metrics = None
        # fault-injection seam (serving/faults.FaultInjector.prestage_hook):
        # called once per worker loop iteration; an injected death raises
        # SystemExit so the thread exits exactly like an unhandled crash
        self.fault_hook = None

    # -- store integration -----------------------------------------------------
    def attach(self, store) -> None:
        store.watch("Pod", self._on_event)
        tracer = store.event_tracer() if hasattr(store, "event_tracer") else None
        if tracer is not None and getattr(tracer, "enabled", False):
            self.podtracer = tracer

    def _on_event(self, event: str, pod) -> None:
        self._queue.append((event, pod))
        self._wake.set()

    # -- worker ----------------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            touch(self, "_worker_wanted")
            self._worker_wanted = True
            if self._thread is not None:
                return
            # a FRESH stop event per worker generation: a start() racing the
            # join window of a concurrent stop() must not resurrect the OLD
            # worker by clearing the event it polls — each worker owns the
            # event it was spawned with, so a set() stops exactly that one
            self._stop = make_event()
            self._thread = spawn_thread(self._run, name="karpenter-prestage", args=(self._stop,))

    def stop(self) -> None:
        """Idempotent and double-call-safe: the thread handle is claimed
        atomically, so two racing stop() calls join once and a stop() after
        stop() is a no-op (the operator shutdown path can hit both)."""
        with self._lock:
            touch(self, "_worker_wanted")
            self._worker_wanted = False
            t, self._thread = self._thread, None
            stop = self._stop
        stop.set()
        self._wake.set()
        if t is not None:
            t.join(timeout=5)

    def worker_running(self) -> bool:
        with self._lock:
            return self._thread is not None

    def worker_alive(self) -> bool:
        """True only when the worker THREAD is actually alive — a dead
        thread leaves the handle set, which is exactly the silent-death
        state worker_running() cannot see."""
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    def ensure_worker(self) -> bool:
        """Supervision: restart a wanted-but-dead worker (injected fault or
        real crash). Called by the serving loop before every pump, so a
        death costs at most one solve of synchronous prep — detected,
        counted (karpenter_solver_prestage_worker_restarts_total), and
        healed instead of silently degrading forever. Returns True when a
        restart happened."""
        with self._lock:
            t = self._thread
            if not self._worker_wanted or (t is not None and t.is_alive()):
                return False
            touch(self, "restarts")
            self.restarts += 1
            # a fresh generation, exactly like start(): new stop event so a
            # racing stop() of the DEAD generation cannot stop this one
            self._stop = make_event()
            self._thread = spawn_thread(self._run, name="karpenter-prestage", args=(self._stop,))
        if self.metrics is not None:
            from ..metrics import SOLVER_PRESTAGE_WORKER_RESTARTS_TOTAL

            self.metrics.counter(SOLVER_PRESTAGE_WORKER_RESTARTS_TOTAL).inc()
        return True

    def _run(self, stop) -> None:
        # `stop` is this worker generation's own event (see start)
        while not stop.is_set():
            hook = self.fault_hook
            if hook is not None:
                try:
                    hook()
                except SystemExit:
                    # the injected worker death: the thread exits exactly
                    # like an unhandled crash would leave it (dead, handle
                    # still set, no signal) — ensure_worker must notice
                    return
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            self.pump()

    def pump(self) -> int:
        """Drain the event queue (worker body; callable inline for
        deterministic single-threaded runs). Returns pods staged."""
        n = 0
        staged_uids: list[str] = []
        while self._queue:
            try:
                event, pod = self._queue.popleft()
            except IndexError:  # pragma: no cover - racing close
                break
            uid = pod.metadata.uid
            if event == "DELETED" or not pod_utils.is_provisionable(pod):
                with self._lock:
                    self._cache.pop(uid, None)
                continue
            if not _stampable(pod):
                continue
            rv = pod.metadata.resource_version
            with self._lock:
                e = self._cache.get(uid)
            if e is not None and not _rv_newer(rv, e[0]):
                # already staged at this (or a NEWER) version: a lagging
                # worker must never overwrite a take-miss entry the current
                # solve just handed out with a stale queued event — that
                # would break clone identity for an unchanged pod
                continue
            # watch events deliver a store-made snapshot clone (shared with
            # the other watchers under the read-only contract) — adopt it as
            # the staged clone instead of cloning again; stamping only adds
            # the signature attribute
            self._stamp(pod)
            with self._lock:
                if len(self._cache) >= _MAX_ENTRIES:
                    self._cache.clear()
                e2 = self._cache.get(uid)
                if e2 is None or _rv_newer(rv, e2[0]):
                    self._cache[uid] = (rv, pod)
                    touch(self, "staged")
                    self.staged += 1
                    n += 1
                    staged_uids.append(uid)
        if staged_uids and self.podtracer is not None:
            # one batched stamp OUTSIDE the prestage lock (tracer is a leaf)
            self.podtracer.on_prestaged_batch(staged_uids)
        return n

    @staticmethod
    def _stamp(pod):
        from ..solver.encode import _batch_stamp

        _batch_stamp([pod])

    @classmethod
    def _clone_and_stamp(cls, pod):
        # the stamp does not survive the clone (deliberately — see _SigStamp);
        # restamp the clone so the encode's columnar grouping path reads it
        clone = fast_deepcopy(pod)
        cls._stamp(clone)
        return clone

    # -- the provisioner-facing surface ---------------------------------------
    def take(self, pod):
        """Return the staged clone for a provisionable store pod, or None
        when the pod must go through the inline path (claim-backed volumes —
        their PVC validation verdict and signature depend on store content
        the (uid, rv) key cannot see; stageable pods trivially validate).
        While (uid, resourceVersion) holds, repeated takes return the SAME
        clone object — the delta-identity contract. A miss clones inline and
        caches the result, so the cache is authoritative for stageable pods
        even when the worker lags."""
        if not _stampable(pod):
            return None
        uid = pod.metadata.uid
        rv = pod.metadata.resource_version
        with self._lock:
            e = self._cache.get(uid)
            if e is not None and e[0] == rv:
                # stats mutate under the SAME lock as the cache: the worker
                # thread bumps `staged` concurrently, and unlocked `+= 1`
                # read-modify-writes lose updates under contention (the
                # guarded-field-access rule pins these to _lock)
                touch(self, "reused")
                self.reused += 1
                return e[1]
        clone = self._clone_and_stamp(pod)
        with self._lock:
            if len(self._cache) >= _MAX_ENTRIES:
                self._cache.clear()
            # same guard as pump(): never overwrite a same-or-newer entry a
            # racing worker just staged (that would flip the pod's clone
            # identity on the next solve); on an equal-rv race the staged
            # clone wins and we hand IT out
            e2 = self._cache.get(uid)
            if e2 is not None and e2[0] == rv:
                touch(self, "reused")
                self.reused += 1
                return e2[1]
            if e2 is None or _rv_newer(rv, e2[0]):
                self._cache[uid] = (rv, clone)
            touch(self, "misses")
            self.misses += 1
        if self.podtracer is not None:
            self.podtracer.on_take_miss(uid)
        return clone

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)
