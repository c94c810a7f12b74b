"""An in-process apiserver substitute: typed object store with optimistic
concurrency, finalizer-gated deletion, and watch fan-out.

Plays the role of the reference's L0 (kube-apiserver/etcd — SURVEY.md layer
map): all durable state lives here; controllers coordinate exclusively through
it. Semantics kept: resourceVersion conflict on stale writes, deletionTimestamp
+ finalizers two-phase delete, watch events (ADDED/MODIFIED/DELETED) delivered
to informers.
"""

from __future__ import annotations

import time

from ..obs.racecheck import make_rlock
from .clone import fast_deepcopy
from typing import Callable, Iterable, Optional


class NotFound(Exception):
    pass


class Conflict(Exception):
    pass


class AlreadyExists(Exception):
    pass


# kinds that are cluster-scoped (key = name, not namespace/name)
CLUSTER_SCOPED = {
    "Node",
    "NodeClaim",
    "NodePool",
    "NodeOverlay",
    "KWOKNodeClass",
    "PriorityClass",
    "StorageClass",
    "PersistentVolume",
    "CSINode",
    "ResourceSlice",
    "DeviceClass",
    "DRAConfig",
}

WatchFn = Callable[[str, object], None]  # (event_type, obj)


def obj_key(obj) -> str:
    meta = obj.metadata
    if obj.kind in CLUSTER_SCOPED:
        return meta.name
    return f"{meta.namespace}/{meta.name}"


class Store:
    """The in-memory 'cluster'. Thread-safe; objects are deep-copied on the
    way in and out so callers can never mutate stored state in place."""

    # the racecheck guarded-field registry (analysis: guarded-field-access;
    # runtime: obs.racecheck.touch). Sanctioned order: `_deliver_lock` may
    # acquire `_lock` (the _drain pop), NEVER the reverse — see the
    # serving-stack lock inventory in karpenter_tpu/serving/__init__.py.
    GUARDED_FIELDS = {
        "_objects": "_lock",
        "_watchers": "_lock",
        "_rv": "_lock",
        "_kind_rv": "_lock",
        "_kind_seq": "_lock",
        "_pending": "_lock",
        "_event_tracer": "_lock",
        "_fault_injector": "_lock",
        "_watch_loss": "_lock",
        "_watch_gap": "_deliver_lock",
        "_watch_base": "_deliver_lock",
    }

    def __init__(self, clock=None):
        self._lock = make_rlock("store")
        self._objects: dict[str, dict[str, object]] = {}  # kind -> key -> obj
        self._watchers: dict[str, list[WatchFn]] = {}
        self._rv = 0
        self._clock = clock
        # watch delivery: events are enqueued under self._lock (commit order,
        # stamped with a monotonic commit time) and drained FIFO under
        # self._deliver_lock, so watchers always observe ADDED < MODIFIED <
        # DELETED in resourceVersion order even with concurrent writers.
        self._pending: list[tuple[str, object, float, int]] = []
        self._deliver_lock = make_rlock("store-deliver")
        # podtrace (obs/podtrace.py): the event-lifecycle tracer's arrival
        # seam — every delivered event is stamped with its commit + delivery
        # monotonic times before the watchers run. None = untraced store.
        self._event_tracer = None
        # faultline (serving/faults.py): the watch-stream fault seam — a
        # FaultInjector may drop, duplicate, or reorder Pod deliveries to
        # prove the serving stack treats the stream as at-least-once and
        # unordered (the store CONTENT stays authoritative). None = the
        # production default: zero-cost, delivery untouched.
        self._fault_injector = None
        # per-kind revision: the rv of the last write touching the kind.
        # Caches that depend on one kind's content (e.g. the solver's volume
        # fold on StorageClass/PV/PVC) key on this instead of the global rv,
        # so unrelated writes don't invalidate them.
        self._kind_rv: dict[str, int] = {}
        # watch-loss detection (faultline): every committed event carries a
        # per-kind delivery SEQUENCE number, and with a fault injector
        # installed the drain observes the delivered seqs like a real
        # informer observes resourceVersions — a gap that survives to
        # queue-quiet (dup and reorder resolve themselves; only a drop
        # cannot) bumps the kind's loss epoch, which level-triggered
        # consumers (Provisioner -> Cluster.resync_pods) poll to re-converge
        # on store content. With no injector the in-process seam is lossless
        # by construction and the tracker stays empty (zero hot-path cost).
        self._kind_seq: dict[str, int] = {}
        self._watch_loss: dict[str, int] = {}  # kind -> cumulative lost-event count
        self._watch_gap: dict[str, list] = {}  # kind -> [watermark, out-of-order seq set]
        self._watch_base: dict[str, int] = {}  # kind -> seq watermark at injector install

    def kind_revision(self, kind: str) -> int:
        with self._lock:
            return self._kind_rv.get(kind, 0)

    def _now(self) -> float:
        return self._clock.now() if self._clock else 0.0

    # -- watches ---------------------------------------------------------------
    def watch(self, kind: str, fn: WatchFn) -> None:
        """Register a watch callback. Execution context contract: callbacks
        run SYNCHRONOUSLY on whatever thread committed the store write,
        under `_deliver_lock` — so they must be cheap and leaf-locked. This
        is the watch->wake seam the serving stack builds on: informer
        mirrors, the provisioner's batcher trigger, and the fleet
        front-end's push wake (`TenantSession._on_watch_event`, which marks
        the tenant runnable and sets the fleet loop's event) all ride it;
        every registered callback is a reviewed entry in the
        `[tool.solverlint] thread-shared` registry (the thread-escape rule
        enforces that at the call site)."""
        with self._lock:
            self._watchers.setdefault(kind, []).append(fn)

    def unwatch(self, kind: str, fn: WatchFn) -> None:
        """Remove a previously-registered watch (no-op if absent) so
        short-lived observers don't accumulate across a suite."""
        with self._lock:
            fns = self._watchers.get(kind)
            if fns is not None and fn in fns:
                fns.remove(fn)

    def set_event_tracer(self, tracer) -> None:
        """Install (or clear) the podtrace event tracer on the delivery seam."""
        with self._lock:
            self._event_tracer = tracer

    def event_tracer(self):
        with self._lock:
            return self._event_tracer

    def set_fault_injector(self, injector) -> None:
        """Install (or clear) a faultline FaultInjector on the delivery seam
        (serving/faults.py: watch-drop / watch-dup / watch-reorder). Taking
        `_deliver_lock` first (the sanctioned order) means no drain is
        mid-flight during the swap, and the gap tracker's baseline is the
        exact seq watermark the lossy stream starts after."""
        with self._deliver_lock:
            with self._lock:
                self._fault_injector = injector
                self._watch_base = dict(self._kind_seq)
                self._watch_gap = {}

    def watch_loss_epoch(self, kind: str) -> int:
        """Cumulative count of watch events detected LOST for `kind` (never
        delivered; duplicates and reorders self-heal and don't count). A
        consumer that mirrors watch events into derived state compares this
        across polls and re-converges from store content on change — the
        level-triggered 'store content is authoritative' contract."""
        with self._lock:
            return self._watch_loss.get(kind, 0)

    def _enqueue(self, event: str, obj) -> None:  # solverlint: ok(guarded-field-access): caller-holds contract — every call site sits inside `with self._lock` (create/update/delete)
        # caller must hold self._lock; the stamp is the event's COMMIT time —
        # podtrace measures queueing delay from commit, not from drain — and
        # the per-kind seq is the delivery sequence the gap tracker audits
        seq = self._kind_seq.get(obj.kind, 0) + 1
        self._kind_seq[obj.kind] = seq
        self._pending.append((event, obj, time.monotonic(), seq))

    def _drain(self) -> None:
        with self._deliver_lock:
            while True:
                with self._lock:
                    if self._pending:
                        event, obj, t_commit, seq = self._pending.pop(0)
                        watchers = list(self._watchers.get(obj.kind, ()))
                    else:
                        event, obj, t_commit, seq, watchers = "", None, 0.0, 0, ()
                    tracer = self._event_tracer
                    injector = self._fault_injector
                if obj is None:
                    if injector is None:
                        return
                    # a reorder fault may have deferred the LAST event of a
                    # burst: flush it now so reordering delays delivery but
                    # can never lose it. The flush is DIRECT — it must not
                    # re-enter the fault matrix, where a due drop rule would
                    # lose the event (and a re-roll would consume a watch
                    # index, shifting every later rule vs the recorded plan)
                    deferred = injector.take_deferred()
                    if deferred is None:
                        # queue AND deferral quiet: any seq still outstanding
                        # in the gap tracker was dropped, never reordered —
                        # publish the loss so level-triggered consumers can
                        # re-converge on store content
                        self._note_watch_loss()
                        return
                    event, obj, t_commit, seq = deferred
                    with self._lock:
                        watchers = list(self._watchers.get(obj.kind, ()))
                    deliveries = ((event, obj, t_commit, seq),)
                elif injector is not None and obj.kind == "Pod":
                    # faultline watch-stream seam: drop / duplicate / reorder
                    # (all deliveries share obj's kind, so `watchers` holds).
                    # Materialize the gap-tracker entry at INTAKE: if this
                    # very event is dropped, _note_watch_loss must still see
                    # the kind to compare its watermark against the
                    # committed seq (the tail-drop case)
                    self._gap_entry(obj.kind)
                    deliveries = injector.on_watch_event(event, obj, t_commit, seq)
                else:
                    deliveries = ((event, obj, t_commit, seq),)
                for event, obj, t_commit, seq in deliveries:
                    if injector is not None:
                        self._observe_delivery(obj.kind, seq)
                    if tracer is not None and obj.kind == "Pod":
                        # arrival stamp BEFORE the watcher fan-out (and even
                        # with no watchers registered): the tracer only reads
                        # scalar fields off the stored object — the borrow
                        # contract. Kind-gated HERE so non-pod deliveries pay
                        # nothing.
                        tracer.on_delivery(event, obj, t_commit, time.monotonic())
                    if not watchers:
                        continue
                    # ONE clone shared by every watcher: watchers may read
                    # and retain it (the stored object is replaced on update,
                    # never mutated, and so is this snapshot) but MUST NOT
                    # mutate — the same contract as borrow_list. Under churn
                    # the per-watcher private clones were the dominant
                    # per-event cost (5 pod watchers -> 5 deep clones per
                    # arrival).
                    c = fast_deepcopy(obj)
                    for fn in watchers:
                        fn(event, c)

    def _gap_entry(self, kind: str) -> list:  # solverlint: ok(guarded-field-access): caller-holds contract — only called from _drain/_observe_delivery, inside `with self._deliver_lock`
        ent = self._watch_gap.get(kind)
        if ent is None:
            ent = self._watch_gap[kind] = [self._watch_base.get(kind, 0), set()]
        return ent

    def _observe_delivery(self, kind: str, seq: int) -> None:  # solverlint: ok(guarded-field-access): caller-holds contract — only called from _drain, inside `with self._deliver_lock`
        # the informer-side audit of the (possibly lossy) delivered stream:
        # contiguous seqs advance the watermark, out-of-order seqs park in
        # the pending set until their gap fills, and seqs at-or-below the
        # watermark are at-least-once duplicates (ignored)
        ent = self._gap_entry(kind)
        if seq == ent[0] + 1:
            ent[0] = seq
            pending = ent[1]
            while ent[0] + 1 in pending:
                pending.discard(ent[0] + 1)
                ent[0] += 1
        elif seq > ent[0] + 1:
            ent[1].add(seq)

    def _note_watch_loss(self) -> None:  # solverlint: ok(guarded-field-access): caller-holds contract — only called from _drain, inside `with self._deliver_lock` (takes `_lock` itself for the committed-seq read + epoch bump)
        # at queue-quiet every reorder has flushed, so any committed seq the
        # tracker never saw delivered was DROPPED — both mid-burst gaps
        # (seqs below max(pending)) and TAIL drops (watermark short of the
        # committed _kind_seq with nothing pending behind it). Count them
        # and adopt the new watermark so one drop is published exactly once.
        with self._lock:
            # a writer may have committed a new event between the drain's
            # empty-queue check and here; its delivery is still coming, so
            # only trust the committed seq as "should have arrived" when
            # the queue is still empty NOW
            committed = dict(self._kind_seq) if not self._pending else {}
            for kind, ent in self._watch_gap.items():
                pending = ent[1]
                top = max(pending) if pending else ent[0]
                top = max(top, committed.get(kind, 0))
                if top <= ent[0] and not pending:
                    continue
                lost = top - ent[0] - len(pending)
                ent[0] = top
                pending.clear()
                if lost > 0:
                    self._watch_loss[kind] = self._watch_loss.get(kind, 0) + lost

    # -- CRUD ------------------------------------------------------------------
    def create(self, obj, adopt: bool = False):
        """`adopt=True`: the caller relinquishes `obj` (must not mutate it
        after the call) and accepts the borrow contract on the return value —
        skips both defensive clones. For high-rate producers (the churn
        harness's event driver) where the per-create clone pair dominates."""
        with self._lock:
            kind_map = self._objects.setdefault(obj.kind, {})
            key = obj_key(obj)
            if key in kind_map:
                raise AlreadyExists(f"{obj.kind} {key} already exists")
            self._rv += 1
            if not adopt:
                obj = fast_deepcopy(obj)
            obj.metadata.resource_version = self._rv
            self._kind_rv[obj.kind] = self._rv
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self._now()
            kind_map[key] = obj
            self._enqueue("ADDED", obj)
        self._drain()
        return obj if adopt else fast_deepcopy(obj)

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            key = name if kind in CLUSTER_SCOPED else f"{namespace}/{name}"
            obj = self._objects.get(kind, {}).get(key)
            if obj is None:
                raise NotFound(f"{kind} {key} not found")
            return fast_deepcopy(obj)

    def try_get(self, kind: str, name: str, namespace: str = "default"):
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(self, kind: str, namespace: Optional[str] = None, label_selector: Optional[dict] = None) -> list:
        """label_selector accepts either the flat {key: value} form or the
        metav1 {matchLabels, matchExpressions} form."""
        # cloning outside the lock is safe: stored objects are replaced on
        # update, never mutated in place
        return [fast_deepcopy(o) for o in self.borrow_list(kind, namespace, label_selector)]

    # -- borrowed reads --------------------------------------------------------
    # client-go's shared informer cache hands controllers pointers into the
    # cache with a MUST-NOT-MUTATE contract — that is what makes the
    # reference's read paths cheap. These are the same primitive: the returned
    # objects are the stored ones; callers may only read them, never mutate or
    # retain them across writes. Hot read-only scans (topology domain counting,
    # provisionable-pod filtering, monitors) use these; anything that mutates
    # goes through get/list, which clone.
    def borrow_list(self, kind: str, namespace: Optional[str] = None, label_selector: Optional[dict] = None) -> list:
        with self._lock:
            out = []
            for obj in self._objects.get(kind, {}).values():
                if namespace is not None and obj.kind not in CLUSTER_SCOPED and obj.metadata.namespace != namespace:
                    continue
                if label_selector is not None and not _selector_matches(label_selector, obj.metadata.labels):
                    continue
                out.append(obj)
            return out

    def borrow_get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            key = name if kind in CLUSTER_SCOPED else f"{namespace}/{name}"
            return self._objects.get(kind, {}).get(key)

    def update(self, obj, _owned: bool = False):
        """Optimistic-concurrency full update; raises Conflict on stale RV.
        `_owned` (internal, patch()): the object is a patch-private clone the
        caller never sees again — skip the defensive clone-in."""
        with self._lock:
            kind_map = self._objects.setdefault(obj.kind, {})
            key = obj_key(obj)
            current = kind_map.get(key)
            if current is None:
                raise NotFound(f"{obj.kind} {key} not found")
            if obj.metadata.resource_version != current.metadata.resource_version:
                raise Conflict(
                    f"{obj.kind} {key}: resourceVersion {obj.metadata.resource_version} != {current.metadata.resource_version}"
                )
            self._rv += 1
            if not _owned:
                obj = fast_deepcopy(obj)
            # deletionTimestamp is set only by delete(); preserve server-side value
            obj.metadata.deletion_timestamp = current.metadata.deletion_timestamp
            obj.metadata.resource_version = self._rv
            self._kind_rv[obj.kind] = self._rv
            # apiserver semantics: generation increments on spec change only
            obj.metadata.generation = current.metadata.generation
            if getattr(obj, "spec", None) != getattr(current, "spec", None):
                obj.metadata.generation += 1
            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                del kind_map[key]
                self._enqueue("DELETED", obj)
            else:
                kind_map[key] = obj
                self._enqueue("MODIFIED", obj)
        self._drain()
        return fast_deepcopy(obj)

    def patch(self, kind: str, name: str, fn: Callable[[object], None], namespace: str = "default", retries: int = 10):
        """Read-modify-write with retry — the common controller patch idiom."""
        for _ in range(retries):
            obj = self.get(kind, name, namespace)
            fn(obj)
            try:
                return self.update(obj, _owned=True)
            except Conflict:
                continue
        raise Conflict(f"{kind} {name}: too many conflicts")

    def update_status(self, obj):
        """Status-subresource style update: spec/labels on the server win."""
        def apply(cur):
            cur.status = fast_deepcopy(obj.status)
        ns = getattr(obj.metadata, "namespace", "default")
        return self.patch(obj.kind, obj.metadata.name, apply, namespace=ns)

    def delete(self, kind: str, name: str, namespace: str = "default", grace: bool = True):
        """Two-phase delete: with finalizers present, sets deletionTimestamp and
        MODIFIED; otherwise removes and emits DELETED."""
        with self._lock:
            key = name if kind in CLUSTER_SCOPED else f"{namespace}/{name}"
            kind_map = self._objects.get(kind, {})
            obj = kind_map.get(key)
            if obj is None:
                raise NotFound(f"{kind} {key} not found")
            self._rv += 1
            # clone-and-replace, like update(): stored objects are NEVER
            # mutated in place — borrowed readers and out-of-lock list()
            # cloning depend on that invariant
            obj = fast_deepcopy(obj)
            obj.metadata.resource_version = self._rv
            self._kind_rv[obj.kind] = self._rv
            if obj.metadata.finalizers and grace:
                if obj.metadata.deletion_timestamp is None:
                    obj.metadata.deletion_timestamp = self._now()
                kind_map[key] = obj
                self._enqueue("MODIFIED", obj)
            else:
                del kind_map[key]
                self._enqueue("DELETED", obj)
        self._drain()

    def try_delete(self, kind: str, name: str, namespace: str = "default") -> bool:
        try:
            self.delete(kind, name, namespace)
            return True
        except NotFound:
            return False

    # -- helpers ---------------------------------------------------------------
    def remove_finalizer(self, kind: str, name: str, finalizer: str, namespace: str = "default"):
        def fn(obj):
            if finalizer in obj.metadata.finalizers:
                obj.metadata.finalizers.remove(finalizer)
        try:
            self.patch(kind, name, fn, namespace=namespace)
        except NotFound:
            pass

    def count(self, kind: str) -> int:
        with self._lock:
            return len(self._objects.get(kind, {}))


def _selector_matches(selector: dict, labels: dict[str, str]) -> bool:
    from .objects import match_label_selector

    if "matchLabels" in selector or "matchExpressions" in selector:
        return match_label_selector(selector, labels)
    return match_label_selector({"matchLabels": selector}, labels)
