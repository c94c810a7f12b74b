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
            out = self.memo[id(x)] = t(self(v) for v in x)
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
