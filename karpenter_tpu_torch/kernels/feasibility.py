"""K1 feasibility: requirement compatibility and the new-slot row key of a
batch of items or pods against every row.

`compat_and_key` launches `csrc/feasibility.cu` for CUDA tensors and runs
`compat_and_key_plain` (the reference's compat_matrix + row_choose_key in
PyTorch) for CPU tensors. The kernel's launch plan (row tiles, blocks, and
whether a block's staged rows spill to a global scratch) is made in the
source; the wrapper only allocates the scratch it asks for. The grouped pack calls it on its items
(`feasibility`), the per-pod pack on its pods."""

from __future__ import annotations

import torch

from ..models.scheduler_model import SchedulerTensors, compat_matrix, row_choose_key
from . import build


def compat_and_key_plain(t: SchedulerTensors, masks, taints_ok, req):
    """([B, Nrows] bool compat, [B, Nrows] f32 key) of B requirement masks
    [B, K, Words], tolerations [B, C] and requests [B, R]."""
    compat = compat_matrix(t.row_labels, t.row_taint_class, masks, taints_ok, t.dom_keys)
    return compat, row_choose_key(t.row_alloc, t.row_pool_rank, req)


def compat_and_key(t: SchedulerTensors, masks, taints_ok, req):
    """K1 on CUDA tensors (one launch for the whole batch), the plain
    version on CPU tensors. The forced keys come from `t.forced_keys`, built
    on the device with the tensors: the call copies nothing from the host
    and does not synchronise."""
    dev = req.device
    if dev.type == "cpu":
        return compat_and_key_plain(t, masks, taints_ok, req)
    if dev.type != "cuda":
        raise build.KernelArgError(f"feasibility: unsupported device {dev}")
    B, K, Words = masks.shape
    Nrows, R = t.row_alloc.shape
    C = taints_ok.shape[1]
    if (t.row_labels.shape != (Nrows, K) or req.shape != (B, R) or taints_ok.shape[0] != B
            or t.forced_keys.shape != (K,)):
        raise build.KernelArgError("feasibility: batch and row axes disagree")
    compat = torch.empty((B, Nrows), dtype=torch.bool, device=dev)
    key = torch.empty((B, Nrows), dtype=torch.float32, device=dev)
    if B == 0 or Nrows == 0:
        return compat, key
    args = [
        build.require(t.row_labels, dev, torch.int32, "row_labels"),
        build.require(t.row_taint_class, dev, torch.int32, "row_taint_class"),
        build.require(t.row_alloc, dev, torch.float32, "row_alloc"),
        build.require(t.row_pool_rank, dev, torch.int32, "row_pool_rank"),
        build.require(masks, dev, torch.int32, "masks"),
        build.require(taints_ok, dev, torch.bool, "taints_ok"),
        build.require(req, dev, torch.float32, "req"),
        build.require(t.forced_keys, dev, torch.bool, "forced_keys"),
    ]
    lib = build.lib()
    words = lib.kt_feasibility_scratch(B, Nrows, K, Words, C, R)
    if words < 0:
        raise build.KernelError("feasibility: no CUDA device to plan the launch on")
    scratch = torch.empty(words, dtype=torch.int32, device=dev) if words else None
    rc = lib.kt_feasibility(*[a.data_ptr() for a in args], B, Nrows, K, Words, C, R, compat.data_ptr(),
                            key.data_ptr(), None if scratch is None else scratch.data_ptr(), build.stream_ptr(dev))
    build.check(rc, "feasibility")
    build.LAUNCHES["feasibility"] += 1
    return compat, key


def feasibility_plain(t: SchedulerTensors, items):
    """([W, Nrows] bool compat, [W, Nrows] f32 key) of the pack's items."""
    return compat_and_key_plain(t, items.item_mask, items.item_taint_ok, items.item_req)


def feasibility(t: SchedulerTensors, items):
    return compat_and_key(t, items.item_mask, items.item_taint_ok, items.item_req)
