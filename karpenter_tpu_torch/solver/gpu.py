"""GPUSolver: the provisioning pack on the GPU, from an encoded problem to a
validated placement, full or as a delta of the previous solve.

The full solve is the counterpart of the reference's `TPUSolver._solve_full`
plus the validation head of `_finish` (solver/tpu.py:688-718, :942-964):
build the work items and the device tensors, pack (kernels K1 -> K2 -> K3),
retry with an uncapped slot axis on overflow, spread each item's pods over
its slots and self-check the placement with `fast_validate`.

The delta solve is the counterpart of `_solve_delta` / `_solve_delta_inner`
(:994-1196). Every sound solve leaves its carry resident; a later problem
whose delta's base is that resident problem is solved from it: the bind
flush's row diff applied, removed pods re-credited (kernel K4), keyed-anti
counts and port planes rebuilt where a removal needs it, only the added pods
packed from the carry (K1 -> K2 -> K3), the assignment merged and the whole
placement validated. Where the reference gives up on the delta it records
why (`last_delta_reject`) and the full GPU pack runs. Decode into node
claims, the hybrid/masked delta and the host fallback are not part of it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models.scheduler_model import SchedulerTensors, make_tensors
from ..models.scheduler_model_grouped import (
    DELTA_ITEM_BUCKET,
    ItemTensors,
    assignment_from_triples,
    build_items,
    greedy_pack_delta_compressed,
    greedy_pack_grouped_compressed,
    item_pad_targets,
    make_item_tensors,
    pad_item_arrays,
    recredit_removals,
    sig_demotions,
)
from .carry import apply_row_diff, rebuild_port_planes, recount_anti_groups
from .check import fast_validate
from .encoded import (
    KIND_DOM_AFF,
    KIND_DOM_ANTI,
    KIND_DOM_SPREAD,
    KIND_HOST_AFF,
    KIND_HOST_ANTI,
    KIND_HOST_SPREAD,
    EncodedProblem,
)

SLOT_CAP = 4096  # slot axis = n_existing + min(n_pods, SLOT_CAP) before the retry

# why a delta-capable solve took the full pack (the reference's strings)
DELTA_REJECT_REASONS = ("no-carry", "irreversible", "slot-exhausted", "validate")


@dataclass
class PackResult:
    assignment: np.ndarray  # [P] slot per pod (-1 = unplaced)
    slot_basis: np.ndarray  # [N] basis row per slot (-1 = closed)
    slot_zoneset: np.ndarray  # [N, D] bool
    leftovers: np.ndarray  # [W] unplaced pods per item (the delta's items on a delta solve)
    open_count: int
    item_info: dict  # n_pods / n_items, and demotions (full) or n_added / n_removed (delta)
    errors: list  # fast_validate violations (empty = sound)
    relaxation_required: bool  # relaxable pods left unplaced: the host relaxation loop must take over
    flat: object  # the pack's flat int32 output (device tensor; None when a delta added no pods)
    state: tuple  # the scan's final carry, left on the device
    tensors: SchedulerTensors
    items: ItemTensors | None  # the packed items (None when a delta added no pods)
    nnz_cap: int
    n_slots: int

    @property
    def n_placed(self) -> int:
        return int((self.assignment >= 0).sum())


class GPUSolver:
    """Runs on the CUDA device unless `device="cpu"` is passed (then every
    kernel wrapper takes its plain PyTorch version).

    `last_solve_mode` is "full" or "delta"; `last_delta_reject` names why the
    last solve did not take the delta path (None when it did). With
    `stage_times=True` each solve records its stages' wall ms, the device
    synchronised after each, in `last_stages`."""

    def __init__(self, device=None, stage_times: bool = False):
        self.device = resolve_device(device)
        self.stage_times = stage_times
        self.last_stages: dict = {}
        self.last_solve_mode = "full"
        self.last_delta_reject: str | None = None
        self._resident: dict | None = None

    @contextmanager
    def _stage(self, name: str):
        if not self.stage_times:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.last_stages[name] = self.last_stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def solve_encoded(self, problem: EncodedProblem) -> PackResult:
        """Solve from the resident carry when the problem is a delta of the
        resident problem (an identical resubmit, or a problem without a
        delta that is the resident one, revalidates from the carry), else
        the full pack."""
        self.last_stages = {}
        self.last_solve_mode = "full"
        self.last_delta_reject = None
        delta = self._solve_delta(problem)
        if delta is not None:
            self.last_solve_mode = "delta"
            return delta
        return self._solve_full(problem)

    def _reject(self, reason: str) -> None:
        self.last_delta_reject = reason

    def _keep_resident(self, problem, t, targets, state, res: PackResult) -> None:
        """The reference keeps the carry of every solve that passed its
        relaxation check and validation (`_finish`)."""
        if res.errors or res.relaxation_required:
            return
        self._resident = dict(problem=problem, t=t, targets=targets, state=state,
                              assignment=np.asarray(res.assignment), slot_basis=np.asarray(res.slot_basis),
                              slot_zoneset=np.asarray(res.slot_zoneset))

    # -- full ------------------------------------------------------------------

    def _solve_full(self, problem: EncodedProblem) -> PackResult:
        p = problem
        with self._stage("build_items"):
            item_arrays, item_pods, info = build_items(p, with_info=True)
            items = make_item_tensors(item_arrays, self.device)
        cap = p.n_existing + min(p.n_pods, SLOT_CAP)
        with self._stage("make_tensors"):
            t = make_tensors(p, self.device, n_slots=cap)
        with self._stage("pack"):
            out = greedy_pack_grouped_compressed(t, items, p.n_pods)
            if out["open_count"] == out["n_slots"] and int(out["leftovers"].sum()) > 0 and cap < p.n_existing + p.n_pods:
                t = make_tensors(p, self.device)
                out = greedy_pack_grouped_compressed(t, items, p.n_pods)
        with self._stage("assignment"):
            assignment = assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], item_pods, p.n_pods)
        relax = bool(p.has_relaxable and (assignment < 0).any())
        with self._stage("validate"):
            errors = fast_validate(p, assignment, out["slot_basis"], out["slot_zoneset"])
        res = PackResult(
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
        self._keep_resident(p, t, item_pad_targets(t, items), out["state"], res)
        return res

    # -- delta -----------------------------------------------------------------

    def _solve_delta(self, problem: EncodedProblem) -> PackResult | None:
        res = self._resident
        base = problem.delta.base if problem.delta is not None else problem
        if res is None or res["problem"] is not base:
            self._reject("no-carry")
            return None
        return self._solve_delta_inner(problem, base)

    def _solve_delta_inner(self, problem: EncodedProblem, base: EncodedProblem) -> PackResult | None:
        p = problem
        d = problem.delta
        res = self._resident
        t = res["t"]
        state = res["state"]
        prev_assignment = res["assignment"]
        slot_basis = res["slot_basis"]
        slot_zoneset = res["slot_zoneset"]

        # bind flush: the carry and the resident tensors take the refreshed
        # existing rows, so they describe the state a fresh encode would
        row_diff = d.row_diff if d is not None else None
        rebuild_ports = bool(row_diff is not None and row_diff.ports_changed)
        if row_diff is not None:
            with self._stage("carry_edits"):
                state, t = apply_row_diff(state, t, p, row_diff)

        removed = d.removed_enc if d is not None else None
        anti_groups = None
        if removed is not None and removed.size:
            rsig = base.sig_of_pod[removed]
            rslot = prev_assignment[removed]
            placed = rslot >= 0
            if placed.any():
                ps = rsig[placed]
                kinds = np.asarray(p.group_kind)
                touch = p.sig_member[ps] | p.sig_owner[ps]
                # required pod affinity is the one family a removal cannot
                # undo: the recorded domain may exist because of the pod
                irrev = (kinds == KIND_DOM_AFF) | (kinds == KIND_HOST_AFF)
                if (touch & irrev[None, :]).any():
                    self._reject("irreversible")
                    return None
                rebuild_ports = rebuild_ports or bool(p.sig_port_any[ps].any())
                touched_anti = touch & (kinds == KIND_DOM_ANTI)[None, :]
                if touched_anti.any():
                    anti_groups = np.nonzero(touched_anti.any(axis=0))[0]
                spread_g = kinds == KIND_DOM_SPREAD
                host_g = (kinds == KIND_HOST_SPREAD) | (kinds == KIND_HOST_ANTI)
                G_pad = int(t.group_kind.shape[0])
                G = kinds.shape[0]
                zmem = np.zeros((int(ps.shape[0]), G_pad), dtype=bool)
                hmem = np.zeros((int(ps.shape[0]), G_pad), dtype=bool)
                zmem[:, :G] = p.sig_member[ps] & spread_g[None, :]
                hmem[:, :G] = p.sig_member[ps] & host_g[None, :]
                with self._stage("recredit"):
                    state = recredit_removals(state, t, rslot[placed].astype(np.int32), p.sig_req[ps], zmem, hmem)
            keep = np.ones(prev_assignment.shape[0], dtype=bool)
            keep[removed] = False
            prev_assignment = prev_assignment[keep]

        n_surv = int(prev_assignment.shape[0])
        surv_sigs = np.asarray(p.sig_of_pod)[:n_surv]
        with self._stage("carry_edits"):
            if anti_groups is not None:
                state = recount_anti_groups(p, slot_zoneset, state, anti_groups, surv_sigs, prev_assignment)
            if rebuild_ports:
                state = state[:7] + (rebuild_port_planes(p, t, state, surv_sigs, prev_assignment),)

        added_sigs = d.added_sigs if d is not None else np.zeros(0, np.int32)
        n_added = int(added_sigs.shape[0])
        n_prev = n_surv
        out = dict(state=state, flat=None, nnz_cap=0, leftovers=np.zeros(0, np.int32))
        items = None
        W_real = 0
        demoted = 0
        if n_added:
            with self._stage("item_build"):
                # the same demotion split as build_items: a demoted
                # multi-group shape packs one item per pod here too
                S = int(p.n_sigs)
                demote_sig, _reason = sig_demotions(p)
                asig = np.asarray(added_sigs, dtype=np.int64)
                demoted = int(demote_sig[asig].sum())
                akey = np.where(demote_sig[asig], S + np.arange(n_added, dtype=np.int64), asig)
                keys_u, inv = np.unique(akey, return_inverse=True)
                inv = inv.reshape(-1)
                sigs_u = np.where(keys_u < S, keys_u, asig[np.clip(keys_u - S, 0, n_added - 1)])
                W_real = int(sigs_u.shape[0])
                arrays = pad_item_arrays(
                    dict(
                        item_req=p.sig_req[sigs_u],
                        item_mask=p.sig_mask[sigs_u],
                        item_taint_ok=p.sig_taint_ok[sigs_u],
                        item_dom_allowed=p.sig_dom_allowed[sigs_u],
                        item_restrict=p.sig_restrict[sigs_u],
                        item_member=p.sig_member[sigs_u],
                        item_owner=p.sig_owner[sigs_u],
                        item_count=np.bincount(inv, minlength=W_real).astype(np.int32),
                        item_port_any=p.sig_port_any[sigs_u],
                        item_port_wild=p.sig_port_wild[sigs_u],
                        item_port_spec=p.sig_port_spec[sigs_u],
                        item_host_blocked=p.sig_host_blocked[sigs_u],
                    ),
                    DELTA_ITEM_BUCKET,
                    # the resident tensors' axes: the item arrays must line up
                    # with the carry the pack continues from
                    targets=res["targets"],
                )
                items = make_item_tensors(arrays, self.device)
                W_pad = arrays["item_count"].shape[0]
                item_pods = [np.nonzero(inv == w)[0] + n_prev for w in range(W_real)]
                item_pods += [np.zeros(0, np.int64)] * (W_pad - W_real)
            with self._stage("pack"):
                out = greedy_pack_delta_compressed(state, t, items, n_added)
            if out["open_count"] == t.n_slots and int(out["leftovers"][:W_real].sum()) > 0:
                self._reject("slot-exhausted")
                return None
            with self._stage("merge"):
                da = assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], item_pods, p.n_pods)
                assignment = np.concatenate([prev_assignment, np.full(n_added, -1, dtype=np.int64)])
                assignment[da >= 0] = da[da >= 0]
            slot_basis = out["slot_basis"]
            slot_zoneset = out["slot_zoneset"]
        else:
            assignment = prev_assignment

        # a failed check retries the full pack fresh
        if p.has_relaxable and (assignment < 0).any():
            self._reject("validate")
            return None
        with self._stage("validate"):
            errors = fast_validate(p, assignment, slot_basis, slot_zoneset)
        if errors:
            self._reject("validate")
            return None
        state = out["state"]
        result = PackResult(
            assignment=assignment,
            slot_basis=slot_basis,
            slot_zoneset=slot_zoneset,
            leftovers=out["leftovers"],
            open_count=int(out.get("open_count", state[6])),
            item_info=dict(n_pods=p.n_pods, n_items=W_real, n_added=n_added,
                           n_removed=int(removed.size) if removed is not None else 0, demoted=demoted,
                           row_refresh=row_diff is not None),
            errors=[],
            relaxation_required=False,
            flat=out["flat"],
            state=state,
            tensors=t,
            items=items,
            nnz_cap=out["nnz_cap"],
            n_slots=t.n_slots,
        )
        self._keep_resident(p, t, res["targets"], state, result)
        return result
