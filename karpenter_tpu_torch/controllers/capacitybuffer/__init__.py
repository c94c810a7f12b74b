"""CapacityBuffer controller (reference: pkg/controllers/capacitybuffer)."""

from .controller import CapacityBufferController, build_virtual_pods, resolve_buffer_pod_spec  # noqa: F401
