"""Masked selection of the per-pod scan (the plain versions; K8 does the
same reductions inside its block)."""

from __future__ import annotations

import torch

BIG = 3.4e38  # f32 stand-in for a masked-out value


def first_true_index(mask: torch.Tensor) -> torch.Tensor:
    """Lowest index where mask is True, else -1 (first-fit order): int32."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    best = torch.where(mask, idx, n).amin()
    return torch.where(best < n, best, -1).to(torch.int32)


def masked_argmin(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Index of the minimum value among mask == True (ties to the lowest
    index), else -1: the argmin runs over the values with masked entries
    replaced by BIG, and its winner counts only when it is masked in."""
    v = torch.where(mask, values, torch.tensor(BIG, dtype=values.dtype, device=values.device))
    best = torch.argmin(v)
    return torch.where(mask[best], best.to(torch.int32), -1).to(torch.int32)
