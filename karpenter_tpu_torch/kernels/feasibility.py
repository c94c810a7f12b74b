"""K1 feasibility: item x row compatibility and row preference key.

`feasibility` launches `csrc/feasibility.cu` for CUDA tensors and runs
`feasibility_plain` (the reference's compat_matrix + row_choose_key in
PyTorch) for CPU tensors."""

from __future__ import annotations

import torch

from ..models.scheduler_model import SchedulerTensors, compat_matrix, row_choose_key
from . import build


def feasibility_plain(t: SchedulerTensors, items):
    """([W, Nrows] bool compat, [W, Nrows] f32 key)."""
    compat = compat_matrix(t.row_labels, t.row_taint_class, items.item_mask, items.item_taint_ok, t.dom_keys)
    key = row_choose_key(t.row_alloc, t.row_pool_rank, items.item_req)
    return compat, key


def feasibility(t: SchedulerTensors, items):
    dev = items.item_req.device
    if dev.type == "cpu":
        return feasibility_plain(t, items)
    if dev.type != "cuda":
        raise ValueError(f"feasibility: unsupported device {dev}")
    W, K, Words = items.item_mask.shape
    Nrows, R = t.row_alloc.shape
    C = items.item_taint_ok.shape[1]
    if t.row_labels.shape != (Nrows, K) or items.item_req.shape != (W, R):
        raise ValueError("feasibility: item and row axes disagree")
    args = [
        build.require(t.row_labels, dev, torch.int32, "row_labels"),
        build.require(t.row_taint_class, dev, torch.int32, "row_taint_class"),
        build.require(t.row_alloc, dev, torch.float32, "row_alloc"),
        build.require(t.row_pool_rank, dev, torch.int32, "row_pool_rank"),
        build.require(items.item_mask, dev, torch.int32, "item_mask"),
        build.require(items.item_taint_ok, dev, torch.bool, "item_taint_ok"),
        build.require(items.item_req, dev, torch.float32, "item_req"),
    ]
    forced = torch.zeros(K, dtype=torch.bool)
    for kk in t.dom_keys:
        if 0 <= kk < K:
            forced[kk] = True
    forced = forced.to(dev)
    compat = torch.empty((W, Nrows), dtype=torch.bool, device=dev)
    key = torch.empty((W, Nrows), dtype=torch.float32, device=dev)
    lib = build.lib()
    rc = lib.kt_feasibility(*[a.data_ptr() for a in args], forced.data_ptr(), W, Nrows, K, Words, C, R,
                            compat.data_ptr(), key.data_ptr(), build.stream_ptr(dev))
    build.check(rc, "feasibility")
    build.LAUNCHES["feasibility"] += 1
    return compat, key
