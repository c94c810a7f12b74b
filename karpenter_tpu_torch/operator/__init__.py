"""Operator runtime: wiring of store, state, controllers, and providers."""

from .runtime import Environment  # noqa: F401
