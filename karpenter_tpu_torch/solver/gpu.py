"""GPUSolver: the full provisioning pack on the GPU, from an encoded problem
to a validated placement.

Counterpart of the reference's `TPUSolver._solve_full` plus the validation
head of `_finish` (solver/tpu.py:688-718, :942-964): build the work items
and the device tensors, pack (kernels K1 -> K2 -> K3), retry with an
uncapped slot axis on overflow, spread each item's pods over its slots and
self-check the placement with `fast_validate`. Decode into node claims, the
delta path, the hybrid split and the host fallback are not part of it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from ..models.scheduler_model import SchedulerTensors, make_tensors
from ..models.scheduler_model_grouped import (
    ItemTensors,
    assignment_from_triples,
    build_items,
    greedy_pack_grouped_compressed,
    make_item_tensors,
)
from .check import fast_validate
from .encoded import EncodedProblem

SLOT_CAP = 4096  # slot axis = n_existing + min(n_pods, SLOT_CAP) before the retry


@dataclass
class PackResult:
    assignment: np.ndarray  # [P] slot per pod (-1 = unplaced)
    slot_basis: np.ndarray  # [N] basis row per slot (-1 = closed)
    slot_zoneset: np.ndarray  # [N, D] bool
    leftovers: np.ndarray  # [W] unplaced pods per item
    open_count: int
    item_info: dict  # n_pods / n_items / demotions
    errors: list  # fast_validate violations (empty = sound)
    relaxation_required: bool  # relaxable pods left unplaced: the host relaxation loop must take over
    flat: object  # the pack's flat int32 output (device tensor)
    state: tuple  # the scan's final carry, left on the device
    tensors: SchedulerTensors
    items: ItemTensors
    nnz_cap: int
    n_slots: int

    @property
    def n_placed(self) -> int:
        return int((self.assignment >= 0).sum())


class GPUSolver:
    """Runs on the CUDA device unless `device="cpu"` is passed (then every
    kernel wrapper takes its plain PyTorch version)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def solve_encoded(self, problem: EncodedProblem) -> PackResult:
        p = problem
        item_arrays, item_pods, info = build_items(p, with_info=True)
        items = make_item_tensors(item_arrays, self.device)
        cap = p.n_existing + min(p.n_pods, SLOT_CAP)
        t = make_tensors(p, self.device, n_slots=cap)
        out = greedy_pack_grouped_compressed(t, items, p.n_pods)
        if out["open_count"] == out["n_slots"] and int(out["leftovers"].sum()) > 0 and cap < p.n_existing + p.n_pods:
            t = make_tensors(p, self.device)
            out = greedy_pack_grouped_compressed(t, items, p.n_pods)
        assignment = assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], item_pods, p.n_pods)
        relax = bool(p.has_relaxable and (assignment < 0).any())
        errors = fast_validate(p, assignment, out["slot_basis"], out["slot_zoneset"])
        return PackResult(
            assignment=assignment,
            slot_basis=out["slot_basis"],
            slot_zoneset=out["slot_zoneset"],
            leftovers=out["leftovers"],
            open_count=out["open_count"],
            item_info=info,
            errors=errors,
            relaxation_required=relax,
            flat=out["flat"],
            state=out["state"],
            tensors=t,
            items=items,
            nnz_cap=out["nnz_cap"],
            n_slots=out["n_slots"],
        )
