"""Requirements algebra: the set/complement/integer-bounds representation of
node-selector terms, and the Requirements collection with intersection and
compatibility checks.

This mirrors the observable semantics of the reference's
pkg/scheduling/requirement.go:36-110 (Requirement: values set + complement flag
+ gte/lte bounds + minValues) and pkg/scheduling/requirements.go:36-110
(Requirements: keyed map with Add-as-intersection, Compatible, Intersects).

This representation is deliberately tensor-friendly: a Requirement is exactly
a fixed-width membership mask over an interned value vocabulary plus two
integer bounds and a complement bit — see karpenter_tpu/solver/encode.py for
the lowering.
"""

from __future__ import annotations

import random
from enum import Enum
from typing import Iterable, Iterator, Mapping

from ..apis import labels as wk

_MAXINT = 2**63 - 1


class Operator(str, Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"
    GTE = "Gte"
    LTE = "Lte"


class Requirement:
    """One constraint on one label key.

    Internal form (reference requirement.go:36-43): a value set plus a
    `complement` flag (NotIn/Exists store the excluded set), and inclusive
    integer bounds gte/lte (Gt/Lt are canonicalized to Gte/Lte).
    """

    __slots__ = ("key", "complement", "values", "gte", "lte", "min_values")

    def __init__(self, key: str, operator: Operator | str, values: Iterable[str] = (), min_values: int | None = None):
        operator = Operator(operator)
        key = wk.normalize_key(key)
        values = [wk.normalize_value(key, v) for v in values]
        self.key = key
        self.min_values = min_values
        self.gte: int | None = None
        self.lte: int | None = None
        if operator == Operator.IN:
            self.complement = False
            self.values = set(values)
            return
        self.complement = operator != Operator.DOES_NOT_EXIST
        self.values = set(values) if operator == Operator.NOT_IN else set()
        if operator in (Operator.GT, Operator.LT, Operator.GTE, Operator.LTE):
            if not values:
                raise ValueError(f"requirement {key}: operator {operator.value} requires a single integer value")
            try:
                v = int(values[0])
            except ValueError:
                raise ValueError(f"requirement {key}: operator {operator.value} value {values[0]!r} is not an integer") from None
            if operator == Operator.GT:
                if v == _MAXINT:
                    # Gt MaxInt matches nothing (requirement.go:89-92)
                    self.complement = False
                    self.values = set()
                else:
                    self.gte = v + 1
            elif operator == Operator.LT:
                self.lte = v - 1
            elif operator == Operator.GTE:
                self.gte = v
            else:
                self.lte = v

    # -- internal constructor --------------------------------------------------
    @classmethod
    def _raw(cls, key: str, complement: bool, values: set, gte, lte, min_values) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = values
        r.gte = gte
        r.lte = lte
        r.min_values = min_values
        return r

    def copy(self) -> "Requirement":
        return Requirement._raw(self.key, self.complement, set(self.values), self.gte, self.lte, self.min_values)

    # -- algebra ---------------------------------------------------------------
    def intersection(self, other: "Requirement") -> "Requirement":
        """Set intersection of two requirements on the same key (requirement.go:181-214)."""
        complement = self.complement and other.complement
        gte = _max_opt(self.gte, other.gte)
        lte = _min_opt(self.lte, other.lte)
        min_values = _max_opt(self.min_values, other.min_values)
        if gte is not None and lte is not None and gte > lte:
            return Requirement._raw(self.key, False, set(), None, None, min_values)

        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = {v for v in values if _within_bounds(v, gte, lte)}
        if not complement:
            gte, lte = None, None
        return Requirement._raw(self.key, complement, values, gte, lte, min_values)

    def has_intersection(self, other: "Requirement") -> bool:
        """Allocation-free intersection test (requirement.go:220-254)."""
        gte = _max_opt(self.gte, other.gte)
        lte = _min_opt(self.lte, other.lte)
        if gte is not None and lte is not None and gte > lte:
            return False
        if self.complement and other.complement:
            return True
        if self.complement and not other.complement:
            return any(v not in self.values and _within_bounds(v, gte, lte) for v in other.values)
        if not self.complement and other.complement:
            return any(v not in other.values and _within_bounds(v, gte, lte) for v in self.values)
        return any(v in other.values and _within_bounds(v, gte, lte) for v in self.values)

    def has(self, value: str) -> bool:
        """True if the requirement allows the value (requirement.go:275-280)."""
        if self.complement:
            return value not in self.values and _within_bounds(value, self.gte, self.lte)
        return value in self.values and _within_bounds(value, self.gte, self.lte)

    def any(self) -> str:
        """A representative allowed value (requirement.go:256-272)."""
        op = self.operator()
        if op == Operator.IN:
            return sorted(self.values)[0]
        if op in (Operator.NOT_IN, Operator.EXISTS):
            if self.gte is not None:
                lo_ = self.gte
            elif self.lte is not None and self.lte < 0:
                lo_ = self.lte - 1000
            else:
                lo_ = 0
            hi_ = (self.lte + 1) if self.lte is not None else max(lo_ + 1, 2**31)
            if hi_ <= lo_:
                return ""  # inverted bounds match nothing
            for _ in range(100):
                v = str(random.randrange(lo_, hi_))
                if v not in self.values:
                    return v
        return ""

    def insert(self, *items: str) -> None:
        self.values.update(items)

    def operator(self) -> Operator:
        if self.complement:
            return Operator.NOT_IN if self.values else Operator.EXISTS
        return Operator.IN if self.values else Operator.DOES_NOT_EXIST

    def __len__(self) -> int:
        if self.complement:
            return _MAXINT - len(self.values)
        return len(self.values)

    def values_list(self) -> list[str]:
        return sorted(self.values)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Requirement)
            and self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.gte == other.gte
            and self.lte == other.lte
            and self.min_values == other.min_values
        )

    def __hash__(self) -> int:
        return hash((self.key, self.complement, frozenset(self.values), self.gte, self.lte))

    def __repr__(self) -> str:
        op = self.operator()
        s = f"{self.key} {op.value}"
        if op in (Operator.IN, Operator.NOT_IN):
            vals = self.values_list()
            if len(vals) > 5:
                vals = vals[:5] + [f"and {len(self.values) - 5} others"]
            s += f" {vals}"
        if self.gte is not None:
            s += f" >={self.gte}"
        if self.lte is not None:
            s += f" <={self.lte}"
        if self.min_values is not None:
            s += f" minValues {self.min_values}"
        return s


def _within_bounds(value: str, gte: int | None, lte: int | None) -> bool:
    if gte is None and lte is None:
        return True
    try:
        v = int(value)
    except (TypeError, ValueError):
        return False
    if gte is not None and v < gte:
        return False
    if lte is not None and v > lte:
        return False
    return True


def _min_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _max_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


class IncompatibleError(Exception):
    """Raised (or returned) when two Requirements sets cannot intersect."""


_LABELS_VIEW_CACHE: dict = {}


class Requirements:
    """A set of Requirements keyed by label, where Add() intersects
    (requirements.go:131-140). Not a dict subclass so we control mutation.
    """

    __slots__ = ("_m",)

    def __init__(self, *reqs: Requirement):
        self._m: dict[str, Requirement] = {}
        self.add(*reqs)

    # -- constructors ----------------------------------------------------------
    @classmethod
    def from_labels(cls, labels: Mapping[str, str] | None) -> "Requirements":
        r = cls()
        for k, v in (labels or {}).items():
            r.add(Requirement(k, Operator.IN, [v]))
        return r

    @classmethod
    def from_labels_view(cls, labels: Mapping[str, str] | None) -> "Requirements":
        """Memoized from_labels for hot read-only call sites (topology domain
        counting runs it per node per group per solve). The returned object is
        SHARED — callers must only read (`matches`, `get`, `compatible`),
        never `add` into it."""
        key = tuple(sorted((labels or {}).items()))
        out = _LABELS_VIEW_CACHE.get(key)
        if out is None:
            if len(_LABELS_VIEW_CACHE) > 16384:
                _LABELS_VIEW_CACHE.clear()
            out = _LABELS_VIEW_CACHE.setdefault(key, cls.from_labels(labels))
        return out

    @classmethod
    def from_node_selector_terms(cls, terms: Iterable[Mapping] | None) -> "Requirements":
        """Build from a list of {key, operator, values, minValues} dicts."""
        r = cls()
        for t in terms or ():
            r.add(Requirement(t["key"], t["operator"], t.get("values", ()), t.get("minValues")))
        return r

    @classmethod
    def from_pod(cls, pod, strict: bool = False) -> "Requirements":
        """Pod scheduling requirements: nodeSelector + first required node-affinity
        term (+ heaviest preferred term unless strict) — requirements.go:74-110.
        """
        r = cls.from_labels(pod.spec.node_selector)
        aff = pod.spec.affinity.node_affinity if pod.spec.affinity else None
        if aff is None:
            return r
        if not strict and aff.preferred:
            heaviest = max(aff.preferred, key=lambda p: p.weight)
            r.add(*Requirements.from_node_selector_terms(heaviest.preference).values())
        if aff.required:
            # Select first OR term; the relaxation loop removes terms when unsatisfiable.
            r.add(*Requirements.from_node_selector_terms(aff.required[0]).values())
        return r

    # -- collection ops --------------------------------------------------------
    def add(self, *reqs: Requirement) -> None:
        for req in reqs:
            existing = self._m.get(req.key)
            if existing is not None:
                req = req.intersection(existing)
            self._m[req.key] = req

    def replace(self, req: Requirement) -> None:
        """Overwrite (not intersect) the requirement for req.key."""
        self._m[req.key] = req

    def remove(self, key: str) -> None:
        """Drop the requirement for key if present (no-op otherwise)."""
        self._m.pop(wk.normalize_key(key), None)

    def get(self, key: str) -> Requirement:
        """Undefined keys behave as Exists (requirements.go:160-166).
        Lookup keys are normalized like stored keys (beta aliases resolve)."""
        key = wk.normalize_key(key)
        r = self._m.get(key)
        if r is None:
            return Requirement(key, Operator.EXISTS)
        return r

    def has(self, key: str) -> bool:
        return wk.normalize_key(key) in self._m

    def keys(self) -> set[str]:
        return set(self._m.keys())

    def values(self) -> list[Requirement]:
        return list(self._m.values())

    def items(self) -> Iterator[tuple[str, Requirement]]:
        return iter(self._m.items())

    def copy(self) -> "Requirements":
        r = Requirements()
        r._m = {k: v.copy() for k, v in self._m.items()}
        return r

    def copy_shallow(self) -> "Requirements":
        """Copy sharing the Requirement entries. Safe because entries are
        immutable by convention — every in-place mutation site copies the
        entry first (see the minValues copy-on-write in nodeclaim.py) and
        add() rebinds keys to new intersection objects."""
        r = Requirements()
        r._m = dict(self._m)
        return r

    def __len__(self) -> int:
        return len(self._m)

    def __contains__(self, key: str) -> bool:
        return wk.normalize_key(key) in self._m

    def __iter__(self) -> Iterator[str]:
        return iter(self._m)

    # -- compatibility ---------------------------------------------------------
    def compatible(self, incoming: "Requirements", allow_undefined: set[str] | frozenset = frozenset()) -> str | None:
        """Ensure incoming requirements can loosely be met (requirements.go:181-199).

        Custom labels must be defined on self (unless the incoming operator is
        NotIn/DoesNotExist); well-known labels (allow_undefined) may be absent.
        Returns an error string or None.
        """
        for key in incoming.keys():
            if key in allow_undefined:
                continue
            op = incoming.get(key).operator()
            if self.has(key) or op in (Operator.NOT_IN, Operator.DOES_NOT_EXIST):
                continue
            return f'label "{key}" does not have known values'
        return self.intersects(incoming)

    def is_compatible(self, incoming: "Requirements", allow_undefined: set[str] | frozenset = frozenset()) -> bool:
        return self.compatible(incoming, allow_undefined) is None

    def intersects(self, incoming: "Requirements") -> str | None:
        """Error string if any shared key has an empty intersection
        (requirements.go:252-286). NotIn/DoesNotExist incoming operators are
        given a more specific 'conflicting' message like the reference.
        """
        sm, im = self._m, incoming._m
        small, large = (sm, im) if len(sm) <= len(im) else (im, sm)
        negative = (Operator.NOT_IN, Operator.DOES_NOT_EXIST)
        for key in small:
            if key not in large:
                continue
            # stored keys are already normalized: skip the get() round-trip
            existing = sm[key]
            inc = im[key]
            if not existing.has_intersection(inc):
                # Two negative requirements (NotIn/DoesNotExist) on the same key
                # never conflict (requirements.go:258-265).
                if inc.operator() in negative and existing.operator() in negative:
                    continue
                return f"key {key}, {inc} not in {existing}"
        return None

    def intersection(self, other: "Requirements") -> "Requirements":
        out = self.copy()
        out.add(*other.values())
        return out

    def labels(self) -> dict[str, str]:
        """Concrete labels for requirements that pin exactly one value."""
        out = {}
        for key, req in self._m.items():
            if req.operator() == Operator.IN and len(req.values) == 1:
                out[key] = req.any()
        return out

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self._m.values())

    def __repr__(self) -> str:
        return "; ".join(repr(r) for r in self._m.values())
