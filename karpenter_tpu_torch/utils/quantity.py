"""Kubernetes resource.Quantity semantics on exact integer milli-units.

The reference manipulates k8s.io/apimachinery resource.Quantity throughout
(e.g. pkg/utils/resources/resources.go). We keep the same observable behavior
(milli precision for divisible resources, binary/decimal SI suffix parsing)
but store a single canonical integer milli-value, which is what the solver's
tensor encoding consumes directly.
"""

from __future__ import annotations

import math
import re
from functools import total_ordering

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4, "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {"n": 10**-9, "u": 10**-6, "m": 10**-3, "": 1, "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}

_QTY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)(Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E)?$")


@total_ordering
class Quantity:
    """An exact resource quantity stored as integer milli-units.

    `Quantity.parse("100m").milli == 100`; `Quantity.parse("2Gi").value == 2**31`.
    Sub-milli parse results round up (a request of 1n still occupies 1m), matching
    the scheduler-visible behavior of MilliValue() in apimachinery.
    """

    __slots__ = ("milli",)

    def __init__(self, milli: int = 0):
        self.milli = int(milli)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def parse(cls, s: "str | int | float | Quantity") -> "Quantity":
        if isinstance(s, Quantity):
            return cls(s.milli)
        if isinstance(s, int):
            return cls(s * 1000)
        if isinstance(s, float):
            return cls(math.ceil(s * 1000))
        s = s.strip()
        m = _QTY_RE.match(s)
        if not m:
            raise ValueError(f"cannot parse quantity {s!r}")
        num, suffix = m.groups()
        suffix = suffix or ""
        if suffix in _BINARY:
            scale = _BINARY[suffix]
        else:
            scale = _DECIMAL[suffix]
        # exact integer fast path
        try:
            base = int(num)
            if isinstance(scale, int):
                return cls(base * scale * 1000)
        except ValueError:
            pass
        val = float(num) * float(scale)
        return cls(math.ceil(val * 1000 - 1e-9))

    @classmethod
    def from_milli(cls, milli: int) -> "Quantity":
        return cls(milli)

    @classmethod
    def from_value(cls, value: "int | float") -> "Quantity":
        return cls(math.ceil(value * 1000 - 1e-9) if isinstance(value, float) else value * 1000)

    # -- accessors ------------------------------------------------------------
    @property
    def value(self) -> int:
        """Whole-unit value, rounded up (apimachinery Value() semantics)."""
        return -((-self.milli) // 1000)

    def as_float(self) -> float:
        return self.milli / 1000.0

    def is_zero(self) -> bool:
        return self.milli == 0

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.milli + other.milli)

    def __sub__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.milli - other.milli)

    def __mul__(self, k: "int | float") -> "Quantity":
        return Quantity(math.ceil(self.milli * k - 1e-9)) if isinstance(k, float) else Quantity(self.milli * k)

    __rmul__ = __mul__

    def __neg__(self) -> "Quantity":
        return Quantity(-self.milli)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Quantity) and self.milli == other.milli

    def __lt__(self, other: "Quantity") -> bool:
        return self.milli < other.milli

    def __hash__(self) -> int:
        return hash(self.milli)

    def __bool__(self) -> bool:
        return self.milli != 0

    # -- formatting -----------------------------------------------------------
    def __str__(self) -> str:
        if self.milli % 1000 == 0:
            v = self.milli // 1000
            for suffix, scale in (("Ei", 1024**6), ("Pi", 1024**5), ("Ti", 1024**4), ("Gi", 1024**3), ("Mi", 1024**2), ("Ki", 1024)):
                if v != 0 and v % scale == 0 and abs(v) >= scale:
                    return f"{v // scale}{suffix}"
            return str(v)
        return f"{self.milli}m"

    def __repr__(self) -> str:
        return f"Quantity({self})"


ZERO = Quantity(0)


def parse(s) -> Quantity:
    return Quantity.parse(s)
