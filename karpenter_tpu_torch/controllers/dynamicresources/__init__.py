"""DRA controllers (reference: pkg/controllers/dynamicresources +
dra-kwok-driver)."""

from .deviceallocation import DeviceAllocationController  # noqa: F401
from .kwokdriver import DRAConfig, DRAKwokDriver  # noqa: F401
