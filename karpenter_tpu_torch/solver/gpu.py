"""GPUSolver: the provisioning solve on the GPU, from a `SolverSnapshot` to
the scheduler's `Results` (new NodeClaims, pods on existing nodes, pod
errors), full or as a delta of the previous solve.

`solve(snap)` is the counterpart of the reference's `TPUSolver.solve`
(solver/tpu.py:427, :636-686) without the hybrid path, the flight recorder
and the recovery ladder: encode the snapshot with the solver's own
`EncodeCache`; send a snapshot with fallback reasons, or an empty one, to
the host FFD (`_fall_back`); otherwise pack it on the device, as a delta of
the resident carry where the encoder linked it to the resident encoding,
else in full; then `_finish`: the relaxation check, `fast_validate`, the
decode into node claims (`_decode`, with the slot-reuse memo of the
previous decode and the minValues repair through `ffd.solve_residual`) and,
only after a successful decode, the resident carry for the next delta
(dropped again after a repair).

The pack is the counterpart of `_solve_full` / `_solve_delta_inner`
(:688-718, :994-1196): build the work items and the device tensors, pack
(kernels K1 -> K2 -> K3), retry with an uncapped slot axis on overflow,
spread each item's pods over its slots and self-check the placement with
`fast_validate`. A delta applies the bind flush's row diff, re-credits
removed pods (kernel K4), rebuilds keyed-anti counts and port planes where a
removal needs it, packs only the added pods from the carry, merges the
assignment and validates the whole placement. Where the reference gives up
on the delta it records why (`last_delta_reject`) and the full pack runs.

`solve_encoded(problem)` runs the same pack on an `EncodedProblem` and
returns the validated placement (`PackResult`) without decoding; it keeps
its carry as soon as the placement validates.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..apis import labels as wk
from ..controllers.provisioning.scheduling.existingnode import ExistingNode
from ..controllers.provisioning.scheduling.nodeclaim import NodeClaimTemplate, SchedulingNodeClaim
from ..controllers.provisioning.scheduling.scheduler import Results
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
from ..scheduling.hostports import pod_host_ports as _php
from ..scheduling.requirements import Operator, Requirement, Requirements
from ..utils import resources as res
from ..utils.quantity import Quantity
from .carry import apply_row_diff, rebuild_port_planes, recount_anti_groups
from .check import fast_validate
from .contracts import maybe_check_encoded
from .encode import EncodeCache, encode
from .encoded import (
    KIND_DOM_AFF,
    KIND_DOM_ANTI,
    KIND_DOM_SPREAD,
    KIND_HOST_AFF,
    KIND_HOST_ANTI,
    KIND_HOST_SPREAD,
    EncodedDelta,
    EncodedProblem,
    from_reference,
)
from .fallback import reason_family as _reason_family
from .ffd import FFDSolver
from .snapshot import SolverSnapshot

SLOT_CAP = 4096  # slot axis = n_existing + min(n_pods, SLOT_CAP) before the retry

# why a delta-capable solve took the full pack (the reference's strings)
DELTA_REJECT_REASONS = ("no-carry", "irreversible", "slot-exhausted", "validate")


def _ports_fit(group_usage, pod_ports: list) -> bool:
    """Can every (pod key, ports) land on a node whose daemon group already
    holds group_usage? Sequential add, like the host CanAdd loop."""
    usage = group_usage.copy()
    for key, ports in pod_ports:
        if usage.conflicts(key, ports) is not None:
            return False
        usage.add(key, ports)
    return True


def _group_fits(groups: list, need_vec, reqs) -> bool:
    """Exact allocatable-offerings-group fits for ITs with override
    offerings: a group counts iff its OWN allocatable covers the need AND it
    holds an offering compatible with the claim requirements
    (nodeclaim.go:624-640 fits over AllocatableOfferingsList)."""
    for gvec, goffs in groups:
        rfit = bool(np.all(gvec >= need_vec))
        for o in goffs:
            if reqs.compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) is None:
                if rfit:
                    return True
                break
    return False


def _compat_offering_mask(its: list, reqs) -> np.ndarray:
    """[len(its)] bool: requirement compat x an available compatible offering
    per instance type (nodeclaim.go:626-640) — the one rule both the decode
    filter and the minValues widening re-filter must share."""
    mask = np.zeros(len(its), dtype=bool)
    for i2, cand in enumerate(its):
        if cand.requirements.intersects(reqs) is None:
            for o in cand.offerings:
                if o.available and reqs.compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) is None:
                    mask[i2] = True
                    break
    return mask


def _requests_from_sigs(enc, sig_counts: dict[int, int]) -> dict:
    """Total ResourceList for a slot from (signature -> pod count): integer
    milli accumulation, one Quantity construction per resource."""
    acc: dict[str, int] = {}
    for s, n in sig_counts.items():
        for k, q in enc.sig_requests[s].items():
            acc[k] = acc.get(k, 0) + q.milli * n
    return {k: Quantity(v) for k, v in acc.items()}


class _NullTopology:
    """Decode-time stand-in: claims are fully determined by the device result."""

    def register(self, *a, **k):
        pass

    def record(self, *a, **k):
        pass

    def add_requirements(self, *a, **k):  # pragma: no cover - not used in decode
        return Requirements()


class DecodeError(RuntimeError):
    """A decoded claim failed its launchability re-check; the solve must be
    retried on the exact host path."""


class _TensorFallback(Exception):
    """Internal control flow: the tensor pack cannot stand behind this
    placement (relaxation needed, validation failed, decode failed). The
    solve converts it into the host FFD fallback."""

    def __init__(self, reasons: list[str], family: str | None = None):
        super().__init__("; ".join(reasons))
        self.reasons = reasons
        self.family = family


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
    targets: dict  # the item axes a later delta's items pad to (`item_pad_targets`)

    @property
    def n_placed(self) -> int:
        return int((self.assignment >= 0).sum())


class GPUSolver:
    """Runs on the CUDA device unless `device="cpu"` is passed (then every
    kernel wrapper takes its plain PyTorch version). `force=True` raises
    where the solve would otherwise fall back to the host FFD.

    After a solve: `last_solve_mode` is "full", "delta" or "fallback";
    `last_backend` is "gpu" (the reference's "tpu") or "ffd-fallback";
    `last_fallback_reasons` lists why the tensor path could not take the
    snapshot and `last_fallback_family` their bounded family (the
    reference's fallback metric label); `last_delta_reject` names why the last solve did not take the
    delta path (None when it did); `last_decode` says how the decode went
    (mode "full" or "delta-reuse", reused and dirty slots). With
    `stage_times=True` each solve records its stages' wall ms, the device
    synchronised after each, in `last_stages`."""

    def __init__(self, device=None, force: bool = False, stage_times: bool = False):
        self.device = resolve_device(device)
        self.force = force
        self.fallback = FFDSolver()
        self.stage_times = stage_times
        self.encode_cache = EncodeCache()
        self.last_stages: dict = {}
        self.last_solve_mode = "full"
        self.last_backend = ""
        self.last_fallback_reasons: list[str] = []
        self.last_fallback_family: str | None = None
        self.last_delta_reject: str | None = None
        self.last_decode: dict = {}
        # the previous solve's tensors, final pack carry (on the device) and
        # assignment, keyed by its problem (and, on the `solve` path, by its
        # encoding): a later delta packs only what changed from it
        self._resident: dict | None = None
        # the previous successful decode's per-slot materializations, keyed
        # to the encoding they were decoded from: a delta whose base is that
        # encoding reuses every slot whose assignment row did not change.
        # Reused claims are rebuilt from the memo's frozen copies.
        self._decode_memo: dict | None = None
        # the instance-type catalog (by object identity) last proven to hold
        # no reserved offerings: steady-state decodes skip the reservation scan
        self._resv_empty_memo: dict | None = None
        # set by the delta solve just before `_finish`: the delta's base
        # encoding, removed base-pod indices and survivor count, which
        # `_decode` needs to prove which slots were untouched; consumed (and
        # cleared) by the next `_decode`
        self._decode_delta_ctx: dict | None = None
        self._decode_repaired = False

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

    # -- the snapshot solve ----------------------------------------------------

    def solve(self, snap: SolverSnapshot) -> Results:
        """One provisioning solve: snapshot in, `Results` out. An exception
        propagates (the reference with `recover=False`)."""
        self.last_stages = {}
        self.last_backend = ""
        self.last_fallback_reasons = []
        self.last_fallback_family = None
        self.last_delta_reject = None
        self.last_decode = {}
        with self._stage("encode"):
            enc = encode(snap, cache=self.encode_cache)
        if getattr(enc, "encode_mode", "full") != "delta":
            # the encoder's own reject reason (None on a cold encode)
            reject = self.encode_cache.last_delta_reject
            if reject is not None:
                self._reject(reject)
        # consume and clear the delta link at once (even on the fallback
        # returns below): each link retains O(P) state
        delta_base = getattr(enc, "delta_base", None)
        if delta_base is not None:
            enc.delta_base = None
        self.last_fallback_reasons = enc.fallback_reasons
        if enc.fallback_reasons:
            if self.force:
                raise RuntimeError(f"tensor path unsupported: {enc.fallback_reasons}")
            return self._fall_back(snap, enc.fallback_reasons)
        if enc.n_pods == 0 or enc.n_rows == 0:
            return self._fall_back(snap, ["empty snapshot"])
        try:
            # an identical resubmit carries no link but is its own base: the
            # empty delta revalidates and decodes straight from the carry
            self.last_solve_mode = "full"
            delta = self._solve_delta(snap, enc, delta_base if delta_base is not None else enc)
            if delta is not None:
                return delta
            return self._solve_full_snapshot(snap, enc)
        except _TensorFallback as e:
            return self._fall_back(snap, e.reasons, family=e.family)

    def _fall_back(self, snap: SolverSnapshot, reasons: list[str], family: str | None = None) -> Results:
        self.last_backend = "ffd-fallback"
        self.last_solve_mode = "fallback"
        self.last_fallback_reasons = reasons
        self.last_fallback_family = family if family is not None else (_reason_family(reasons[0]) if reasons else "empty")
        with self._stage("fallback"):
            return self.fallback.solve(snap)

    def _solve_full_snapshot(self, snap: SolverSnapshot, enc) -> Results:
        # KARPENTER_SOLVER_TYPECHECK=1: the pack entry re-validates the
        # encoding's shape/dtype contracts
        maybe_check_encoded(enc, where="pack-full")
        with self._stage("copy"):
            problem = from_reference(enc)
        pack = self._solve_full(problem)
        return self._finish(snap, enc, problem, pack)

    def _solve_delta(self, snap: SolverSnapshot, enc, base) -> Results | None:
        """The delta solve from the resident carry when `base` (the encoder's
        delta link, or the encoding itself on an identical resubmit) is the
        resident encoding; None when the full pack must run."""
        resident = self._resident
        if resident is None or resident.get("enc") is not base:
            # no carry, or a carry of another encoding (the reference would
            # try its masked delta here, which without a hybrid carry also
            # ends on the full pack)
            self._reject("no-carry")
            return None
        maybe_check_encoded(enc, where="pack-delta")
        base_problem = resident["problem"]
        with self._stage("copy"):
            if enc is base:
                problem = replace(base_problem, delta=EncodedDelta(
                    added_sigs=np.zeros(0, np.int32), removed_enc=np.zeros(0, np.int64), row_diff=None,
                    base=base_problem))
            else:
                problem = from_reference(enc, base=base_problem)
        pack = self._solve_delta_inner(problem, base_problem)
        if pack is None:
            return None
        self.last_solve_mode = "delta"
        removed = problem.delta.removed_enc
        n_prev = problem.n_pods - int(problem.delta.added_sigs.shape[0])
        # this problem is the solver's own and the carry is keyed by `enc`:
        # drop its delta, and so its link to the base problem, before
        # `_finish` keeps it, or each resident problem would hold every
        # problem before it (each link retains O(P) state)
        problem.delta = None
        # decode-delta handoff: the validated assignment continues the base
        # decode's slot layout — tell _decode which base the memo must match
        # and which slots the delta touched (removed base pods' slots + the
        # appended tail's slots); everything else is provably unchanged
        self._decode_delta_ctx = dict(
            base=base,
            removed=np.asarray(removed, dtype=np.int64) if removed.size else None,
            n_prev=n_prev,
        )
        return self._finish(snap, enc, problem, pack, validated=True)

    def _finish(self, snap, enc, problem: EncodedProblem, pack: PackResult, validated: bool = False) -> Results:
        """The shared solve tail (full and delta): relaxation check,
        validation verdict, decode, and the resident carry — kept only
        after a successful decode, dropped after a minValues repair.
        `validated=True`: the delta path validated before committing."""
        # tier-0 honored every soft constraint; an unplaced pod means the
        # host relaxation loop must take over
        if pack.relaxation_required:
            if self.force:
                raise RuntimeError("tier-0 solve left relaxable pods unplaced")
            raise _TensorFallback(["relaxation required: soft constraints unsatisfiable tier-0"], family="relaxation")
        violations = [] if validated else pack.errors
        if violations:
            if self.force:
                raise RuntimeError(f"tensor placement failed validation: {violations}")
            raise _TensorFallback([f"validation: {v}" for v in violations], family="validation")
        try:
            with self._stage("decode"):
                results = self._decode(snap, enc, pack.assignment, pack.slot_basis, pack.slot_zoneset)
        except DecodeError as e:
            if self.force:
                raise
            raise _TensorFallback([f"validation: {e}"], family="validation")
        if self._decode_repaired:
            # a minValues host repair re-solved part of the placement off the
            # carry: the device state no longer matches the Results — drop it
            # so the next solve takes the cold path
            self._resident = None
        else:
            self._keep_resident(problem, pack, enc=enc)
        return results

    # -- the encoded solve -----------------------------------------------------

    def solve_encoded(self, problem: EncodedProblem) -> PackResult:
        """Solve from the resident carry when the problem is a delta of the
        resident problem (an identical resubmit, or a problem without a
        delta that is the resident one, revalidates from the carry), else
        the full pack. No decode: the carry is kept once the placement
        validates."""
        self.last_stages = {}
        self.last_solve_mode = "full"
        self.last_delta_reject = None
        resident = self._resident
        base = problem.delta.base if problem.delta is not None else problem
        if resident is None or resident["problem"] is not base:
            self._reject("no-carry")
        else:
            pack = self._solve_delta_inner(problem, base)
            if pack is not None:
                self.last_solve_mode = "delta"
                self._keep_resident(problem, pack)
                return pack
        pack = self._solve_full(problem)
        if not (pack.errors or pack.relaxation_required):
            self._keep_resident(problem, pack)
        return pack

    def global_repack_plan_encoded(self, problem, seed: int = 0):
        """One global repack proposal pass on an encoded consolidation round
        (`solver.consolidation.ConsolidationProblem`, pending pods as extra
        classes): the counterpart of the reference's
        `TPUSolver.global_repack_plan`, without its flight record. Returns
        (subsets best-first, info); proposals only, exact validation is the
        caller's."""
        from .consolidation import propose_subsets_global

        return propose_subsets_global(problem, self.device, seed=seed)

    def _reject(self, reason: str) -> None:
        self.last_delta_reject = reason

    def _keep_resident(self, problem: EncodedProblem, pack: PackResult, enc=None) -> None:
        self._resident = dict(problem=problem, enc=enc, t=pack.tensors, targets=pack.targets, state=pack.state,
                              assignment=np.asarray(pack.assignment), slot_basis=np.asarray(pack.slot_basis),
                              slot_zoneset=np.asarray(pack.slot_zoneset))

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
            targets=item_pad_targets(t, items),
        )

    # -- delta -----------------------------------------------------------------

    def _solve_delta_inner(self, problem: EncodedProblem, base: EncodedProblem) -> PackResult | None:
        p = problem
        d = problem.delta
        resident = self._resident
        t = resident["t"]
        state = resident["state"]
        prev_assignment = resident["assignment"]
        slot_basis = resident["slot_basis"]
        slot_zoneset = resident["slot_zoneset"]

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
                    targets=resident["targets"],
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
        return PackResult(
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
            targets=resident["targets"],
        )

    # -- the repair's topology export ------------------------------------------

    @staticmethod
    def _seam_records(enc, keep: np.ndarray, tensor_results: Results) -> list:
        """Exported topology group counts for the minValues repair:
        (pod, taints, requirements) per tensor-placed pod that a group
        touching the repaired signatures (`~keep`) counts, for
        `ffd.solve_residual` to record into the residual Topology.

        Each record carries the placement's CONCRETE requirements — the
        claim's (with its committed domain pin and adopted hostname) or the
        existing node's label view — so the host's own counting rule
        (selector + node filter + single-value domain) applies unchanged.

        Every group kind counts, and a group need not touch a kept
        signature: a repair splits CLAIMS (not whole signatures), so a group
        touching only the repaired signatures still has surviving placements
        the repair must see, and repaired pods can belong to any group kind —
        `Topology.record` applies the host counting semantics per kind. (The
        reference's hybrid path, not ported yet, also asks for the
        spread-only, cross-seam subset.)"""
        if not enc.n_groups:
            return []
        touches = enc.sig_member | enc.sig_owner
        cross = touches[~keep].any(axis=0)
        if not cross.any():
            return []
        # record EVERY placed pod the seam groups count (not just kept-sig
        # pods): a repair can split one signature across the seam
        seam_sig = touches[:, cross].any(axis=1)
        if not seam_sig.any():
            return []
        sig_of = {id(p): int(s) for p, s in zip(enc.pods, np.asarray(enc.sig_of_pod))}
        records: list = []
        for en in tensor_results.existing_nodes:
            for pod in en.pods:
                s = sig_of.get(id(pod))
                if s is not None and seam_sig[s]:
                    # decode-built ExistingNode requirements are the node's
                    # label view + hostname — exactly what record() needs
                    records.append((pod, en.taints, en.requirements))
        for nc in tensor_results.new_node_claims:
            for pod in nc.pods:
                s = sig_of.get(id(pod))
                if s is not None and seam_sig[s]:
                    # captured by reference: _adopt_claim adds the in-flight
                    # hostname requirement in place before the records replay
                    records.append((pod, nc.template.taints, nc.requirements))
        return records

    # -- decode ----------------------------------------------------------------

    def _decode(self, snap: SolverSnapshot, enc, assignment: np.ndarray, slot_basis: np.ndarray, slot_zoneset: np.ndarray) -> Results:
        self.last_backend = "gpu"
        self._decode_repaired = False
        repair_pods: list = []  # minValues host repair (bounded, rare)
        repair_sigs: set[int] = set()
        null_topo = _NullTopology()

        # decode-delta carry: consume the delta handoff (if any) and the
        # previous decode's memo; both are re-established on a successful
        # decode, so any raising path below leaves no stale carry behind
        delta_ctx, self._decode_delta_ctx = self._decode_delta_ctx, None
        memo, self._decode_memo = self._decode_memo, None

        assignment = np.asarray(assignment)
        slot_basis = np.asarray(slot_basis)
        slot_zoneset = np.asarray(slot_zoneset)
        n_slots = int(slot_basis.shape[0])
        pod_errors: dict[str, str] = {}
        for i in np.nonzero(assignment < 0)[0]:
            pod_errors[enc.pods[i].key()] = "no feasible placement found by tensor solver"
        valid_idx = np.nonzero(assignment >= 0)[0]
        # per-slot pod counts: one bincount — drives slot totals AND the
        # delta dirty mask (a survivor keeps its slot by construction, so
        # count-equal + untouched-by-the-delta == identical membership)
        counts = (
            np.bincount(assignment[valid_idx].astype(np.int64), minlength=n_slots)
            if valid_idx.size
            else np.zeros(n_slots, dtype=np.int64)
        )

        existing_nodes: list[ExistingNode] = []
        existing_by_slot: dict[int, ExistingNode] = {}
        for j in range(enc.n_existing):
            sn = enc.row_meta[j][1]
            # daemon headroom is already folded into row_alloc
            en = ExistingNode(sn, null_topo, sn.taints(), {}, False)
            existing_nodes.append(en)
            existing_by_slot[j] = en

        # host-side reserved-capacity cap: claims are walked in slot order and
        # pessimistically reserve compatible reserved offerings the way the
        # FFD's per-claim offeringsToReserve does; claims that cannot reserve
        # are pinned away from reserved capacity so the launch can never
        # oversubscribe a reservation
        reservation_manager = None
        if snap.reserved_capacity_enabled:
            from ..controllers.provisioning.scheduling.reservationmanager import ReservationManager

            # the no-reserved-offerings verdict is a pure function of the
            # instance-type catalog: memoize it on the catalog OBJECT
            memo_empty = self._resv_empty_memo
            if memo_empty is None or memo_empty is not snap.instance_types:
                reservation_manager = ReservationManager(snap.instance_types)
                if not reservation_manager.capacity:
                    reservation_manager = None  # no reserved offerings anywhere
                    self._resv_empty_memo = snap.instance_types
                else:
                    self._resv_empty_memo = None

        # decode-delta reuse gate: the memo must describe exactly the encoding
        # this delta continued from, and reservations must be off (the
        # reservation walk is sequential cross-slot state)
        reusable: np.ndarray | None = None
        if (
            memo is not None
            and delta_ctx is not None
            and reservation_manager is None
            and memo["enc"] is delta_ctx["base"]
            and memo["counts"].shape[0] == n_slots
            and memo["slot_zoneset"].shape == slot_zoneset.shape
        ):
            # a slot is dirty iff its membership/basis/zoneset could have
            # changed: count drift, basis/zoneset row drift, a removed base
            # pod's slot, or an appended (delta-added) pod's slot
            dirty = memo["counts"] != counts
            dirty |= memo["slot_basis"] != slot_basis
            dirty |= np.any(memo["slot_zoneset"] != slot_zoneset, axis=1)
            dirty |= (counts > 0) & ~memo["has_entry"]
            removed_base = delta_ctx.get("removed")
            if removed_base is not None:
                rs = memo["assignment"][removed_base]
                dirty[rs[rs >= 0]] = True
            n_prev = int(delta_ctx["n_prev"])
            if assignment.shape[0] > n_prev:
                tail = assignment[n_prev:]
                dirty[tail[tail >= 0]] = True
            # offering availability flips in place between solves: a
            # new-claim slot whose template's availability vector moved must
            # re-filter
            avail_now: dict[int, tuple] = {}
            for j_m, ent_m in sorted(memo["new"].items()):
                sig_m = avail_now.get(id(ent_m["template"]))
                if sig_m is None:
                    sig_m = avail_now[id(ent_m["template"])] = tuple(
                        o.available for x in ent_m["template"].instance_type_options for o in x.offerings
                    )
                if sig_m != ent_m["avail"]:
                    dirty[j_m] = True
            reusable = ~dirty

        # group pods by slot — one vectorized argsort/unique pass; on the
        # reuse path only DIRTY slots' pods are gathered at all
        gather_idx = valid_idx if reusable is None else valid_idx[~reusable[assignment[valid_idx]]]
        order = gather_idx[np.argsort(assignment[gather_idx], kind="stable")]
        slots_sorted = assignment[order]
        uniq_slots, starts = np.unique(slots_sorted, return_index=True)
        bounds = np.append(starts[1:], len(order))
        pods_by_slot: dict[int, np.ndarray] = {
            int(s): order[a:b] for s, a, b in zip(uniq_slots, starts, bounds)
        }

        # per-dom-key vocab views for requirement pinning (zone is key 0)
        dko = np.asarray(enc.dom_key_of)
        Kd = len(enc.dom_key_names)
        D = enc.n_doms
        key_all_vals = [
            {enc.dom_values[d] for d in range(Kd, D) if dko[d] == k} for k in range(Kd)
        ]

        # per-slot work dedupes by SIGNATURE. The instance filter splits into
        # a requirements part (compat + offering, cached per distinct
        # (template, req-class set, domain-set)) and a fits part (a numpy
        # compare of the slot's total request vector against the template's
        # allocatable matrix). The caches live on the encoder's row
        # artifacts (the lifetime of the template objects their keys
        # reference) and key requirement classes by CONTENT, so a warm
        # re-solve reuses the previous solve's filtering.
        sig_of_pod = np.asarray(enc.sig_of_pod)
        rc_of_sig = enc.req_class_of_sig
        dc = enc.decode_cache
        if len(dc.get("mask", ())) > 100_000:
            dc.clear()  # churn guard; repopulates in one solve
        overhead_groups_cache: dict[int, list] = dc.setdefault("ovh", {})
        mask_cache: dict[tuple, np.ndarray] = dc.setdefault("mask", {})
        req_cache: dict[tuple, Requirements] = dc.setdefault("req", {})
        tmpl_ctx_cache: dict[int, tuple] = dc.setdefault("tmpl", {})
        # per-decode layer over _template_ctx: availability is stable within
        # one decode, so its guard scan runs once per template here
        tmpl_solve_cache: dict[int, tuple] = {}
        # per-signature-multiset request-total interning: each distinct
        # total is built once and every slot gets its own shallow copy
        reqtot_cache: dict[tuple, dict] = dc.setdefault("reqtot", {})
        new_claims: list[SchedulingNodeClaim] = []

        # the NEXT memo, built alongside this decode (carried entries for
        # reused slots, fresh entries for materialized ones); off under
        # reservations
        save_new: dict[int, dict] | None = {} if reservation_manager is None else None
        save_existing: dict[int, dict] | None = {} if save_new is not None else None
        avail_sig_cache: dict[int, tuple] = {}

        def _avail_of(template):
            sig = avail_sig_cache.get(id(template))
            if sig is None:
                sig = avail_sig_cache[id(template)] = tuple(
                    o.available for x in template.instance_type_options for o in x.offerings
                )
            return sig

        # slot total request vectors, one bincount per resource axis — only
        # over the gathered (dirty) pods; reused slots never need totals
        R = enc.sig_req.shape[1]
        total_mat = np.zeros((n_slots, R), dtype=np.float64)
        if gather_idx.size:
            pr = enc.sig_req[sig_of_pod[gather_idx]]
            gslots = assignment[gather_idx]
            for r in range(R):
                total_mat[:, r] = np.bincount(gslots, weights=pr[:, r], minlength=n_slots)

        reused_slots = 0
        slot_list = sorted(pods_by_slot)
        if reusable is not None:
            reuse_j = np.nonzero(reusable & (counts > 0))[0]
            slot_list = sorted(set(slot_list) | {int(x) for x in reuse_j})
        for j in slot_list:
            if reusable is not None and reusable[j] and j not in pods_by_slot:
                # clean slot: serve it from the memo. New-claim slots REBUILD
                # the claim object from the memo's frozen copies — downstream
                # adopters mutate claims in place, so handing out the previous
                # solve's object would poison the carry
                ent = memo["new"].get(j)
                if ent is not None:
                    claim = SchedulingNodeClaim.__new__(SchedulingNodeClaim)
                    claim.template = ent["template"]
                    claim.topology = null_topo
                    claim.daemon_overhead_groups = ent["groups"]
                    claim.pods = list(ent["pods"])
                    claim.hostname = f"tpu-slot-{j}"
                    claim.spec_requests = dict(ent["requests"])
                    claim.requirements = ent["reqs"].copy()
                    claim.instance_type_options = list(ent["its"])
                    new_claims.append(claim)
                    if save_new is not None:
                        save_new[j] = ent
                else:
                    ent = memo["existing"][j]
                    en = existing_by_slot[j]
                    en.pods.extend(ent["pods"])
                    en.remaining_resources = res.subtract(en.remaining_resources, ent["requests"])
                    if save_existing is not None:
                        save_existing[j] = ent
                reused_slots += 1
                continue
            pod_idxs = pods_by_slot[j]
            pods = [enc.pods[i] for i in pod_idxs]
            usigs, ucounts = np.unique(sig_of_pod[pod_idxs], return_counts=True)
            sig_counts = {int(s): int(n) for s, n in zip(usigs, ucounts)}
            rt_key = tuple(zip(usigs.tolist(), ucounts.tolist()))
            rt = reqtot_cache.get(rt_key)
            if rt is None:
                rt = reqtot_cache[rt_key] = _requests_from_sigs(enc, sig_counts)
            requests = dict(rt)
            if j < enc.n_existing:
                en = existing_by_slot[j]
                en.pods.extend(pods)
                en.remaining_resources = res.subtract(en.remaining_resources, requests)
                if save_existing is not None:
                    save_existing[j] = dict(pods=tuple(pods), requests=requests)
                continue

            row = int(slot_basis[j])
            _, template, it, offering = enc.row_meta[row]
            claim = SchedulingNodeClaim.__new__(SchedulingNodeClaim)
            claim.template = template
            claim.topology = null_topo
            claim.daemon_overhead_groups = self._overhead_groups(template, snap, overhead_groups_cache)
            claim.pods = pods
            claim.hostname = f"tpu-slot-{j}"
            claim.spec_requests = requests

            # domains: pin a key only when the packer committed/narrowed the
            # slot below the key's full universe (late committal — matches
            # the FFD's topology narrowing); zone is dom key 0
            dom_sig = tuple(int(d) for d in np.nonzero(slot_zoneset[j])[0])
            # requirement classes keyed by CONTENT so the cross-solve cache
            # can never alias solve-local integer ids; the preference policy
            # changes how a class lowers, so it keys too
            rc_key = frozenset(enc.req_class_keys[int(rc_of_sig[s])] for s in sig_counts)
            rkey = (id(template), rc_key, dom_sig, getattr(snap, "preference_policy", "Respect"))
            reqs = req_cache.get(rkey)
            if reqs is None:
                reqs = Requirements()
                reqs.add(*template.requirements.values())
                for s in sorted(sig_counts):
                    reqs.add(*enc.sig_requirements[s].values())
                for k in range(Kd):
                    vals = [enc.dom_values[d] for d in dom_sig if d >= Kd and dko[d] == k]
                    if vals and set(vals) != key_all_vals[k]:
                        reqs.add(Requirement(enc.dom_key_names[k], "In", vals))
                req_cache[rkey] = reqs
            # copies: claims are mutated downstream (finalize drops hostname
            # reqs); a shared Requirements would couple sibling slots
            claim.requirements = reqs.copy()

            ctx = tmpl_solve_cache.get(id(template))
            if ctx is None:
                ctx = tmpl_solve_cache[id(template)] = self._template_ctx(template, claim.daemon_overhead_groups, enc, tmpl_ctx_cache)
            its, alloc_mat, ginfo, ov_groups = ctx
            mask = mask_cache.get(rkey)
            if mask is None:
                mask = mask_cache[rkey] = _compat_offering_mask(its, reqs)
            total_vec = total_mat[j]
            # groups whose daemon-reserved ports conflict with the slot's
            # pods can never host them; the per-signature port masks say for
            # free whether ANY of the slot's pods carries host ports
            if enc.sig_port_any[usigs].any():
                pod_ports = [(p.key(), _php(p)) for p in pods]
                pod_ports = [(k, ps) for k, ps in pod_ports if ps]
            else:
                pod_ports = []

            def survivors(reqs_x, mask_x, ginfo=ginfo, its=its, alloc_mat=alloc_mat, ov_groups=ov_groups, total_vec=total_vec, pod_ports=pod_ports):
                out_l = []
                for members, ovh, gusage in ginfo:
                    if not members:
                        continue
                    if pod_ports and not _ports_fit(gusage, pod_ports):
                        continue
                    fits = np.all(alloc_mat[members] >= total_vec[None, :] + ovh[None, :], axis=1)
                    surv = fits & mask_x[members]
                    if ov_groups:
                        # ITs with override offerings use the exact group-wise
                        # fits (a group's own allocatable × a compatible offering
                        # in THAT group — nodeclaim.go:624-640)
                        for pos, m in enumerate(members):
                            if m in ov_groups and its[m].requirements.intersects(reqs_x) is None:
                                surv[pos] = _group_fits(ov_groups[m], total_vec + ovh, reqs_x)
                    out_l.extend(its[m] for m, ok in zip(members, surv) if ok)
                return out_l

            remaining = survivors(reqs, mask)
            if not remaining:
                # the post-filter set must never be empty when the kernel is
                # sound; before trusting the single packed row, re-check it is
                # launchable under the claim's FINAL requirements — compat,
                # an available offering, and the accumulated-requests fit
                # (nodeclaim.go:541-618 semantics)
                it_idx = next((i2 for i2, cand in enumerate(its) if cand is it), None)
                entry = next(
                    ((ovh, gusage) for members, ovh, gusage in ginfo if it_idx is not None and it_idx in members),
                    None,
                )
                if it_idx is not None and it_idx in ov_groups:
                    it_fit = entry is not None and _group_fits(
                        ov_groups[it_idx], total_vec + entry[0], claim.requirements
                    )
                else:
                    it_fit = (
                        it_idx is not None
                        and entry is not None
                        and bool(np.all(alloc_mat[it_idx] >= total_vec + entry[0]))
                    )
                it_ok = (
                    it.requirements.intersects(claim.requirements) is None
                    and any(
                        o.available and claim.requirements.compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) is None
                        for o in it.offerings
                    )
                    # fit INCLUDING the row's daemon-overhead group and its
                    # reserved ports, exactly like the vectorized filter above
                    and it_fit
                    and (entry is not None and (not pod_ports or _ports_fit(entry[1], pod_ports)))
                )
                if not it_ok:
                    raise DecodeError(f"slot {j}: packed row {it.name} not launchable under final claim requirements")
                remaining = [it]
            if claim.requirements.has_min_values():
                # tensorized minValues: the pack ran unconstrained; enforce
                # the per-claim flexibility bound now — widening decode pins,
                # relaxing under BestEffort, or handing the claim's pods to
                # the bounded host repair below
                remaining = self._enforce_min_values(
                    snap, enc, claim, remaining, sig_counts, dom_sig, key_all_vals, its, survivors
                )
                if remaining is None:
                    repair_pods.extend(pods)
                    repair_sigs.update(int(s) for s in usigs)
                    continue
            claim.instance_type_options = remaining
            if reservation_manager is not None:
                self._apply_reservations(claim, reservation_manager)
            new_claims.append(claim)
            if save_new is not None:
                # frozen copies only: the adopted claim's pods/requests/
                # requirements/options are all mutated downstream
                save_new[j] = dict(
                    template=template,
                    groups=claim.daemon_overhead_groups,
                    pods=tuple(pods),
                    requests=dict(requests),
                    reqs=claim.requirements.copy(),
                    its=tuple(remaining),
                    avail=_avail_of(template),
                )

        self.last_decode = dict(
            mode="delta-reuse" if reused_slots else "full",
            reused_slots=reused_slots,
            dirty_slots=len(pods_by_slot),
        )
        if save_new is not None and not repair_pods:
            has_entry = np.zeros(n_slots, dtype=bool)
            if save_new:
                has_entry[list(save_new)] = True
            if save_existing:
                has_entry[list(save_existing)] = True
            self._decode_memo = dict(
                enc=enc,
                assignment=assignment.copy(),
                counts=counts,
                slot_basis=slot_basis.copy(),
                slot_zoneset=slot_zoneset.copy(),
                has_entry=has_entry,
                new=save_new,
                existing=save_existing,
            )

        results = Results(
            new_node_claims=new_claims,
            existing_nodes=existing_nodes,
            pod_errors=pod_errors,
        )
        if repair_pods:
            # bounded host repair: pods of the claims whose minValues could
            # not be met tensor-side re-solve on the exact host path against
            # the rest of this placement — host Strict semantics restored per
            # pod. The surviving placements' topology occupancy is exported
            # so the repair cannot violate a group the repaired pods share
            # with them (repairs split CLAIMS, so one signature can sit on
            # both sides: every group kind, no cross-seam requirement).
            from .ffd import solve_residual

            self._decode_repaired = True
            self.last_decode.update(repair_pods=len(repair_pods), repair_sigs=len(repair_sigs))
            keep = np.ones(enc.n_sigs, dtype=bool)
            keep[sorted(repair_sigs)] = False
            results = solve_residual(
                snap, repair_pods, results,
                seam_records=self._seam_records(enc, keep, results),
            )
        return results

    def _enforce_min_values(self, snap, enc, claim, remaining, sig_counts, dom_sig, key_all_vals, its, survivors):
        """Per-claim decode-time minValues relaxation. Mirrors the host's
        claim-open behavior (nodeclaim.py filter_instance_types + can_add
        relax_min_values):

        1. `satisfies_min_values` over the post-filter instance types — the
           common case passes untouched.
        2. WIDEN: drop every decode-added domain pin that nothing
           load-bearing depends on (no topology group constrains the key
           for this slot's pods, and neither pod requirements nor inverse
           anti-affinity narrow their domain masks) and re-filter on the
           widened set.
        3. Under the BestEffort policy, relax the bound to the observed
           count exactly like `can_add(relax_min_values=True)`.
        4. Otherwise return None: the claim's pods take the bounded host
           repair (ffd.solve_residual), which reproduces the host's Strict
           per-pod errors.
        """
        from ..cloudprovider.types import satisfies_min_values

        _, unsat = satisfies_min_values(remaining, claim.requirements)
        if not unsat:
            return remaining
        Kd = len(enc.dom_key_names)
        dko = np.asarray(enc.dom_key_of)
        sigs = sorted(sig_counts)
        gd = np.asarray(enc.group_dom_key)
        widen: set[int] = set()
        for k in range(Kd):
            vals = [enc.dom_values[d] for d in dom_sig if d >= Kd and dko[d] == k]
            if not (vals and set(vals) != key_all_vals[k]):
                continue  # decode added no pin for this key
            gmask = gd == k
            if gmask.any() and (enc.sig_member[sigs][:, gmask] | enc.sig_owner[sigs][:, gmask]).any():
                continue  # a topology group rides the commitment: load-bearing
            keydoms = (dko == k) & (np.arange(enc.n_doms) >= Kd)
            if not all(enc.sig_dom_allowed[s, keydoms].all() for s in sigs):
                continue  # pod reqs / inverse anti-affinity narrow the key
            widen.add(k)
        if widen:
            reqs_w = Requirements()
            reqs_w.add(*claim.template.requirements.values())
            for s in sigs:
                reqs_w.add(*enc.sig_requirements[s].values())
            for k in range(Kd):
                if k in widen:
                    continue
                vals = [enc.dom_values[d] for d in dom_sig if d >= Kd and dko[d] == k]
                if vals and set(vals) != key_all_vals[k]:
                    reqs_w.add(Requirement(enc.dom_key_names[k], "In", vals))
            claim.requirements = reqs_w
            remaining = survivors(reqs_w, _compat_offering_mask(its, reqs_w))
            _, unsat = satisfies_min_values(remaining, claim.requirements)
            if not unsat:
                return remaining
        if not remaining:
            # the widened filter can come back empty when the original
            # survivors set was empty and decode fell back to the single
            # packed row — a claim with no instance types is unlaunchable
            # under ANY policy, so route its pods to the host repair
            return None
        if getattr(snap, "min_values_policy", "Strict") == "BestEffort":
            # copy-on-write like the host: entries may alias template-owned
            # Requirement objects
            for key, mv in unsat.items():
                relaxed = claim.requirements.get(key).copy()
                relaxed.min_values = mv
                claim.requirements.replace(relaxed)
            return remaining
        return None

    @staticmethod
    def _apply_reservations(claim, reservation_manager) -> None:
        """Reserve compatible reserved offerings for this claim and pin its
        requirements (mirrors nodeclaim.go offeringsToReserve:303-350 +
        FinalizeScheduling:394-404); claims beyond a reservation's capacity
        are excluded from reserved capacity entirely."""
        has_compatible = False
        reservable = []
        for cand in claim.instance_type_options:
            for o in cand.offerings:
                if not o.available or o.capacity_type() != wk.CAPACITY_TYPE_RESERVED:
                    continue
                if claim.requirements.compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) is not None:
                    continue
                has_compatible = True
                if reservation_manager.can_reserve(claim.hostname, o):
                    reservable.append(o)
        if reservable:
            reservation_manager.reserve(claim.hostname, *reservable)
            claim.reserved_offerings = reservable
            claim.requirements.replace(Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [wk.CAPACITY_TYPE_RESERVED]))
            rids = sorted({o.reservation_id() for o in reservable})
            claim.requirements.replace(Requirement(wk.RESERVATION_ID_LABEL_KEY, "In", rids))
        elif has_compatible:
            # reserved capacity exhausted by earlier claims in this solve:
            # keep this claim off reserved offerings
            cur = claim.requirements.get(wk.CAPACITY_TYPE_LABEL_KEY)
            if cur.operator() == Operator.IN:
                allowed = [v for v in cur.values_list() if v != wk.CAPACITY_TYPE_RESERVED]
                if allowed:
                    claim.requirements.replace(Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", allowed))
            else:
                claim.requirements.replace(Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "NotIn", [wk.CAPACITY_TYPE_RESERVED]))

    @staticmethod
    def _template_ctx(template, groups, enc, cache: dict):
        """Per-template numpy context for the vectorized fits filter: the
        instance-type list, its allocatable matrix in encode's scaled units,
        and per-daemon-overhead-group (member indices, overhead vector)."""
        key = id(template)
        # offering availability is flipped in place between solves while this
        # cache outlives one decode — key the entry on the live availability
        # vector so stale override groups can never overrule a fresh mask
        avail_sig = tuple(
            o.available for x in template.instance_type_options for o in x.offerings
        )
        entry = cache.get(key)
        ctx = entry[1] if entry is not None and entry[0] == avail_sig else None
        if ctx is None:
            from .encode import _scale
            from .volumes import CSI_AXIS_BIG, CSI_AXIS_PREFIX

            rnames = enc.resource_names
            ridx = {k: i for i, k in enumerate(rnames)}
            its = template.instance_type_options
            it_idx = {id(x): i for i, x in enumerate(its)}
            alloc = np.zeros((len(its), len(rnames)), dtype=np.float64)
            for i, x in enumerate(its):
                for k, q in x.allocatable().items():
                    r = ridx.get(k)
                    if r is not None:
                        alloc[i, r] = _scale(k, q)
            # CSI attach axes: new claims are unbounded (limits are an
            # existing-node property — see solver/volumes.py)
            csi_cols = [r for r, name in enumerate(rnames) if name.startswith(CSI_AXIS_PREFIX)]
            for r in csi_cols:
                alloc[:, r] = CSI_AXIS_BIG
            # instance types with override offerings carry ALL their
            # allocatable groups for the exact group-wise fits check
            # (types.go AllocatableOfferingsList; most ITs have none)
            ov_groups: dict[int, list] = {}
            for i, x in enumerate(its):
                groups_l = x.allocatable_offerings_list()
                if len(groups_l) > 1:
                    entries = []
                    for galloc, goffs in groups_l:
                        gvec = np.zeros(len(rnames), dtype=np.float64)
                        for k, q in galloc.items():
                            r = ridx.get(k)
                            if r is not None:
                                gvec[r] = _scale(k, q)
                        for r in csi_cols:
                            gvec[r] = CSI_AXIS_BIG
                        entries.append((gvec, goffs))
                    ov_groups[i] = entries
            ginfo = []
            for g in groups:
                ovh = np.zeros(len(rnames), dtype=np.float64)
                for k, q in (g.daemon_overhead or {}).items():
                    r = ridx.get(k)
                    if r is not None:
                        ovh[r] = _scale(k, q)
                ginfo.append(([it_idx[id(x)] for x in g.instance_types if id(x) in it_idx], ovh, g.host_port_usage))
            ctx = (its, alloc, ginfo, ov_groups)
            cache[key] = (avail_sig, ctx)
        return ctx

    @staticmethod
    def _overhead_groups(template: NodeClaimTemplate, snap: SolverSnapshot, cache: dict) -> list:
        from ..controllers.provisioning.scheduling.scheduler import _compute_daemon_overhead_groups

        key = id(template)
        if key not in cache:
            cache[key] = _compute_daemon_overhead_groups(template, snap.daemonset_pods)
        return cache[key]
