"""Host-side utilities: exact quantity/resource arithmetic, clocks."""

from .quantity import Quantity  # noqa: F401
