"""Carry a reference `SolverSnapshot` over into the port's object model.

This is the counterpart of loading another framework's weights: the two
packages hold the same object model in classes of the same module path and
name, so a reference snapshot is walked by class and field name and rebuilt
from the port's classes, keeping every name, uid, timestamp and resource
version. Shared references stay shared (one instance-type list serving two
nodepools is one list here too). The store is refilled with the carried
objects at the reference's revisions, and the cluster mirror is rebuilt from
it through the port's informers.

The reference's classes are recognised by their module path
(`karpenter_tpu.<module>`); nothing of the reference package is imported.
Only tests call this.
"""

from __future__ import annotations

import importlib
import itertools
import threading
from enum import Enum

from ..kube.store import Store
from ..solver.snapshot import SolverSnapshot
from ..state.cluster import Cluster
from ..state.informer import start_informers

REFERENCE = "karpenter_tpu"
PORT = "karpenter_tpu_torch"

# per-object caches of the reference's encoder, which a deep copy drops too
_DROPPED = frozenset({"_sig_stamp"})
_ATOMS = frozenset({str, int, float, bool, bytes, type(None)})
_LOCK = type(threading.Lock())
_RLOCK = type(threading.RLock())
# the snapshot's plain fields, copied as they are
_SETTINGS = ("preference_policy", "min_values_policy", "enforce_consolidate_after", "dra_enabled",
             "reserved_capacity_enabled", "reserved_offering_mode", "collect_zone_metrics")


def port_class(ref_cls: type) -> type:
    """The port's class of the same module path and name as `ref_cls`."""
    mod = ref_cls.__module__
    if mod != REFERENCE and not mod.startswith(REFERENCE + "."):
        raise TypeError(f"{ref_cls.__qualname__} ({mod}) is not a class of the reference package")
    target = importlib.import_module(PORT + mod[len(REFERENCE):])
    for part in ref_cls.__qualname__.split("."):
        target = getattr(target, part)
    return target


class _Carrier:
    def __init__(self):
        self.memo: dict[int, object] = {}
        self.keep: list = []  # the originals, so no id() is reused mid-walk

    def __call__(self, x):
        if type(x) in _ATOMS:
            return x
        got = self.memo.get(id(x))
        if got is not None:
            return got
        self.keep.append(x)
        t = type(x)
        if t is list:
            out = self.memo[id(x)] = []
            out.extend(self(v) for v in x)
        elif t is dict:
            out = self.memo[id(x)] = {}
            for k, v in x.items():
                out[self(k)] = self(v)
        elif t is tuple:
            out = self.memo[id(x)] = tuple(self(v) for v in x)
        elif t is set or t is frozenset:
            items = [self(v) for v in x]
            out = self.memo[id(x)] = _same_order(t, items) if all(type(v) in _ATOMS for v in items) else t(items)
        elif isinstance(x, Enum):
            out = self.memo[id(x)] = port_class(t)[x.name]
        elif t is _LOCK or t is _RLOCK or t.__name__ == "InstrumentedLock":
            # a fresh lock of the same kind (the reference's sanitizer lock
            # says which kind it wraps)
            reentrant = t is _RLOCK or bool(getattr(x, "reentrant", False))
            out = self.memo[id(x)] = threading.RLock() if reentrant else threading.Lock()
        else:
            out = self._instance(x)
        return out

    def _instance(self, x):
        cls = port_class(type(x))
        out = self.memo[id(x)] = cls.__new__(cls)
        for k in _slots(type(x)):
            if hasattr(x, k):
                object.__setattr__(out, k, self(getattr(x, k)))
        d = getattr(x, "__dict__", None)
        if d is not None:
            for k, v in d.items():
                if k not in _DROPPED:
                    out.__dict__[k] = self(v)
        return out


def _same_order(t: type, items: list):
    """A set (or frozenset) of the atoms `items` that iterates in their
    order, the original set's. A set's order follows the hash table's
    layout, which depends on the order its elements went in; the host
    scheduler breaks some ties by the order of a set (a spread's candidate
    domains), so a carried set must iterate as its original does. Insertion
    orders are tried until one gives the original's order: the original's
    own, sorted, reversed, then (up to 7 elements) every permutation."""
    out = t(items)
    if list(out) == items:
        return out
    tries = [sorted(items, key=repr), sorted(items, key=repr, reverse=True)]
    if len(items) <= 7:
        tries = itertools.chain(tries, itertools.permutations(items))
    for order in tries:
        cand = t(order)
        if list(cand) == items:
            return cand
    return out


def _slots(t: type) -> list:
    out = []
    for c in t.__mro__:
        s = c.__dict__.get("__slots__", ())
        out += [s] if isinstance(s, str) else [n for n in s if n not in ("__dict__", "__weakref__")]
    return out


def carry_objects(x):
    """Any reference object, or a container of them, carried over on its
    own (as pods appended to a carried snapshot are)."""
    return _Carrier()(x)


def _store(ref, carry: _Carrier) -> Store:
    """A port store holding the reference store's objects at their
    revisions, with no watchers."""
    store = Store(clock=carry(ref._clock))
    with ref._lock:
        objects, rv = dict(ref._objects), ref._rv
        kind_rv, kind_seq = dict(ref._kind_rv), dict(ref._kind_seq)
    store._objects = {kind: {key: carry(o) for key, o in objs.items()} for kind, objs in objects.items()}
    store._rv = rv
    store._kind_rv = kind_rv
    store._kind_seq = kind_seq
    return store


def snapshot_from_reference(ref_snap) -> SolverSnapshot:
    """The port's snapshot of the same cluster as `ref_snap`: its store's
    objects, nodepools, instance types, daemonset pods, pods and state
    nodes carried over by class and field name; its cluster rebuilt through
    the port's informers from the carried store."""
    if getattr(ref_snap, "registry", None) is not None:
        raise NotImplementedError("a metrics registry cannot be carried over: the port has none")
    carry = _Carrier()
    clock = carry(ref_snap.clock)
    store = None
    cluster = None
    if ref_snap.store is not None:
        store = _store(ref_snap.store, carry)
        cluster = Cluster(store, clock)
        start_informers(store, cluster)
    return SolverSnapshot(
        store=store,
        cluster=cluster,
        node_pools=carry(ref_snap.node_pools),
        instance_types=carry(ref_snap.instance_types),
        state_nodes=carry(ref_snap.state_nodes),
        daemonset_pods=carry(ref_snap.daemonset_pods),
        pods=carry(ref_snap.pods),
        clock=clock,
        deleting_node_names=set(ref_snap.deleting_node_names),
        **{name: getattr(ref_snap, name) for name in _SETTINGS},
    )


class SnapshotMirror:
    """A sequence of reference snapshots over one cluster, carried over step
    after step into one port-side cluster, as a chain of solves needs it.

    One carrier serves the whole sequence, so a reference object carried
    once stays the same port object (the encoder's delta path walks the pod
    list by identity, and its row key holds the instance types' identity);
    the top-level lists are rebuilt each step, since the reference mutates
    them in place. One port store follows the reference's: objects the
    reference store gained since the last step are created in the port's
    in revision order (both stores then hand out the same revisions), and
    the port's informers keep its cluster in step. An update or a deletion
    in the reference store raises `NotImplementedError`."""

    def __init__(self):
        self.carry = _Carrier()
        self.ref_store = None
        self.store: Store | None = None
        self.cluster: Cluster | None = None

    def _sync(self) -> None:
        ref = self.ref_store
        with ref._lock:
            objects = {kind: dict(objs) for kind, objs in ref._objects.items()}
            rv = ref._rv
        new = []
        for kind, objs in objects.items():
            mine = self.store._objects.get(kind, {})
            for key, obj in objs.items():
                have = mine.get(key)
                if have is None:
                    new.append(obj)
                elif have.metadata.resource_version != obj.metadata.resource_version:
                    raise NotImplementedError(f"{kind} {key} was updated in the reference store")
            if set(mine) - set(objs):
                raise NotImplementedError(f"a {kind} was deleted from the reference store")
        for obj in sorted(new, key=lambda o: o.metadata.resource_version):
            self.store.create(self.carry(obj))
        if self.store._rv != rv:
            raise NotImplementedError(f"the stores' revisions differ: {self.store._rv} != {rv}")

    def snapshot(self, ref_snap) -> SolverSnapshot:
        """The port's snapshot of this step of the sequence."""
        if getattr(ref_snap, "registry", None) is not None:
            raise NotImplementedError("a metrics registry cannot be carried over: the port has none")
        carry = self.carry
        clock = carry(ref_snap.clock)
        clock.set(ref_snap.clock.now())
        if ref_snap.store is not None:
            if self.ref_store is None:
                self.ref_store = ref_snap.store
                self.store = _store(ref_snap.store, carry)
                self.cluster = Cluster(self.store, clock)
                start_informers(self.store, self.cluster)
            elif ref_snap.store is not self.ref_store:
                raise ValueError("a mirror follows the store of one reference cluster")
            else:
                self._sync()
        return SolverSnapshot(
            store=self.store if ref_snap.store is not None else None,
            cluster=self.cluster if ref_snap.store is not None else None,
            node_pools=[carry(np_) for np_ in ref_snap.node_pools],
            instance_types={name: carry(its) for name, its in ref_snap.instance_types.items()},
            state_nodes=[carry(sn) for sn in ref_snap.state_nodes],
            daemonset_pods=[carry(p) for p in ref_snap.daemonset_pods],
            pods=[carry(p) for p in ref_snap.pods],
            clock=clock,
            deleting_node_names=set(ref_snap.deleting_node_names),
            **{name: getattr(ref_snap, name) for name in _SETTINGS},
        )

    def reference(self, port_obj):
        """The reference object a port object was carried from."""
        back = getattr(self, "_back", None)
        if back is None or len(back) != len(self.carry.memo):
            by_id = {id(x): x for x in self.carry.keep}
            back = self._back = {id(v): by_id[k] for k, v in self.carry.memo.items()}
        return back[id(port_obj)]
