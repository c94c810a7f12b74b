"""PyTorch + CUDA port of the karpenter-tpu device solver.

The package starts at the encoder's output contract (`solver.encoded.
EncodedProblem`, the numpy arrays of an encoded snapshot) and ends at the
validated placement: `solver.gpu.GPUSolver.solve_encoded` builds the device
tensors, runs the signature-grouped pack through hand-written CUDA kernels
(`kernels/csrc/*.cu`) and checks the result with `fast_validate`. A problem
that carries a delta of the previous one is solved from the device-resident
carry of that solve: removals re-credited, only the added pods packed.

Around it stands the reference's host side, copied: the object model, the
host scheduler and encoder, the provisioner, disruption, DRA, metrics and
observability, and the operator (`operator.Environment`), which wires every
controller and runs a whole controller round with the provisioner's
`GPUSolver` on the card.

Every entry point runs on the CUDA device unless the caller passes
`device="cpu"`; on CPU tensors each kernel wrapper runs its plain PyTorch
version instead. The package imports torch and numpy only; importing the
package itself imports neither, so its stdlib-only linter
(`python -m karpenter_tpu_torch.analysis`) runs without them.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
