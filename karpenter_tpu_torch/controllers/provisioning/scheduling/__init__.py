"""The provisioning scheduler: FFD bin-packing simulation with topology,
preference relaxation, and instance-type filtering.

This is the host-side exact implementation (the reference semantics,
scheduler.go:440 Solve). The TPU tensor backend (karpenter_tpu/solver/) plugs
in at the Solver boundary and is validated against this one.
"""

from .queue import Queue  # noqa: F401
from .scheduler import Results, Scheduler  # noqa: F401
