"""K3 sparsify: ordered compaction of the take matrix into the pack's flat
int32 output. `flat_outputs` launches `csrc/sparsify.cu` (one launch) for
CUDA tensors and runs the plain `_flat_outputs` for CPU tensors.

The kernel keeps its ticket, epoch and per-row status words in a small
scratch that it leaves ready for its next launch; the wrapper keeps one per
device and stream, zeroed when it is allocated or grown."""

from __future__ import annotations

import torch

from ..models.scheduler_model_grouped import _flat_outputs
from . import build

flat_outputs_plain = _flat_outputs
_SCRATCH: dict = {}


def _scratch(dev, words: int):
    """The kernel's scratch for this device and stream: at least `words`
    int64 words, zeroed when allocated (the kernel leaves it ready)."""
    key = (dev.index, build.stream_ptr(dev))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 1024), dtype=torch.int64, device=dev)
        _SCRATCH[key] = buf
    return buf


def flat_outputs(takes, leftovers, slot_basis, slot_zoneset, open_count, nnz_cap: int):
    dev = takes.device
    if dev.type == "cpu":
        return _flat_outputs(takes, leftovers, slot_basis, slot_zoneset, open_count, nnz_cap)
    if dev.type != "cuda":
        raise build.KernelArgError(f"flat_outputs: unsupported device {dev}")
    W, N = takes.shape
    D = slot_zoneset.shape[1]
    if slot_basis.shape != (N,) or slot_zoneset.shape[0] != N or leftovers.shape != (W,):
        raise build.KernelArgError("flat_outputs: take matrix and carry axes disagree")
    args = [
        build.require(takes, dev, torch.int32, "takes"),
        build.require(leftovers, dev, torch.int32, "leftovers"),
        build.require(slot_basis, dev, torch.int32, "slot_basis"),
        build.require(slot_zoneset, dev, torch.bool, "slot_zoneset"),
        build.require(open_count.reshape(1), dev, torch.int32, "open_count"),
    ]
    scratch = _scratch(dev, 4 + W)
    flat = torch.empty(3 * nnz_cap + N + N * D + W + 1, dtype=torch.int32, device=dev)
    lib = build.lib()
    rc = lib.kt_sparsify(*[a.data_ptr() for a in args], W, N, D, int(nnz_cap), scratch.data_ptr(), flat.data_ptr(),
                         build.stream_ptr(dev))
    build.check(rc, "sparsify")
    build.LAUNCHES["sparsify"] += 1
    return flat
