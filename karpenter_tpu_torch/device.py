"""Device selection: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device and raises when CUDA is absent; the CPU
    is used only when the caller names it (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("karpenter_tpu_torch needs a CUDA device; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
