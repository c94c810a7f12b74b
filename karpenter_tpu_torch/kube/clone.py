"""Fast deep-clone for stored API objects.

The Store isolates callers from stored state by copying every object on the
way in and out (the reference gets this for free from apiserver
serialization). `copy.deepcopy` was the control plane's dominant cost at
reference scale (1,000-2,000 pods — host_name_spreading_test.go:59-67): its
memo dict and reflective dispatch cost ~30x what these closed-shape objects
need. This module is a structural-sharing clone specialized to the object
model:

- immutable leaves are SHARED, not copied: str/int/float/bool/None, Quantity
  (never mutated after construction), frozen dataclasses with immutable
  fields (Taint, Toleration), Enum members;
- containers and mutable dataclasses are rebuilt recursively with no memo
  (the object model is a tree — no aliasing or cycles to preserve);
- unknown types fall back to copy.deepcopy, so correctness never depends on
  this registry being complete.
"""

from __future__ import annotations

import copy as _copy
from enum import Enum

from ..scheduling.taints import Taint, Toleration
from ..utils.quantity import Quantity

# shared-on-clone leaf types (immutable, or verified never mutated in place)
_ATOMS = frozenset({str, int, float, bool, bytes, type(None), Quantity, Taint, Toleration})

_CLONERS: dict = {}


def fast_deepcopy(x):
    t = x.__class__
    if t in _ATOMS:
        return x
    if t is dict:
        return {k: fast_deepcopy(v) for k, v in x.items()}
    if t is list:
        return [fast_deepcopy(v) for v in x]
    cloner = _CLONERS.get(t)
    if cloner is None:
        cloner = _CLONERS.setdefault(t, _make_cloner(t))
    return cloner(x)


def _clone_tuple(x):
    return tuple(fast_deepcopy(v) for v in x)


def _clone_set(x):
    return {fast_deepcopy(v) for v in x}


def _clone_instance(x):
    # plain-__dict__ object (all the kube/apis dataclasses): allocate without
    # __init__ and rebuild fields, sharing atomic leaves
    t = x.__class__
    new = t.__new__(t)
    d = new.__dict__
    atoms = _ATOMS
    for k, v in x.__dict__.items():
        d[k] = v if v.__class__ in atoms else fast_deepcopy(v)
    return new


def _make_cloner(t):
    import types

    if t is tuple:
        return _clone_tuple
    if t is set or t is frozenset:
        return _clone_set
    if issubclass(t, Enum) or issubclass(t, (types.FunctionType, types.BuiltinFunctionType, type, types.ModuleType)):
        return lambda x: x  # singletons / identity-preserving
    if issubclass(t, (dict, list, tuple, set)):
        return _copy.deepcopy  # container subclass with unknown invariants
    if getattr(t, "__deepcopy__", None) is not None or getattr(t, "__slots__", None) is not None:
        return _copy.deepcopy
    try:
        probe = t.__new__(t)
        probe.__dict__  # noqa: B018 — instances must carry a plain __dict__
    except Exception:  # solverlint: ok(swallowed-exception): capability probe — classes without a plain __dict__ route to the stdlib deepcopy fallback
        return _copy.deepcopy
    return _clone_instance
