"""K3 sparsify: ordered compaction of the take matrix into the pack's flat
int32 output. `flat_outputs` launches `csrc/sparsify.cu` for CUDA tensors
and runs the plain `_flat_outputs` for CPU tensors."""

from __future__ import annotations

import torch

from ..models.scheduler_model_grouped import _flat_outputs
from . import build

flat_outputs_plain = _flat_outputs


def flat_outputs(takes, leftovers, slot_basis, slot_zoneset, open_count, nnz_cap: int):
    dev = takes.device
    if dev.type == "cpu":
        return _flat_outputs(takes, leftovers, slot_basis, slot_zoneset, open_count, nnz_cap)
    if dev.type != "cuda":
        raise ValueError(f"flat_outputs: unsupported device {dev}")
    W, N = takes.shape
    D = slot_zoneset.shape[1]
    if slot_basis.shape != (N,) or slot_zoneset.shape[0] != N or leftovers.shape != (W,):
        raise ValueError("flat_outputs: take matrix and carry axes disagree")
    args = [
        build.require(takes, dev, torch.int32, "takes"),
        build.require(leftovers, dev, torch.int32, "leftovers"),
        build.require(slot_basis, dev, torch.int32, "slot_basis"),
        build.require(slot_zoneset, dev, torch.bool, "slot_zoneset"),
        build.require(open_count.reshape(1), dev, torch.int32, "open_count"),
    ]
    scratch = torch.empty(2 * W + 1, dtype=torch.int32, device=dev)
    flat = torch.empty(3 * nnz_cap + N + N * D + W + 1, dtype=torch.int32, device=dev)
    lib = build.lib()
    rc = lib.kt_sparsify(*[a.data_ptr() for a in args], W, N, D, int(nnz_cap), scratch.data_ptr(), flat.data_ptr(),
                         build.stream_ptr(dev))
    build.check(rc, "sparsify")
    build.LAUNCHES["sparsify"] += 1
    return flat
