"""PyTorch + CUDA port of the karpenter-tpu device solver.

The package starts at the encoder's output contract (`solver.encoded.
EncodedProblem`, the numpy arrays of an encoded snapshot) and ends at the
validated placement: `solver.gpu.GPUSolver.solve_encoded` builds the device
tensors, runs the signature-grouped pack through three hand-written CUDA
kernels (`kernels/csrc/*.cu`) and checks the result with `fast_validate`.

Every entry point runs on the CUDA device unless the caller passes
`device="cpu"`; on CPU tensors each kernel wrapper runs its plain PyTorch
version instead. The package imports torch and numpy only.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
