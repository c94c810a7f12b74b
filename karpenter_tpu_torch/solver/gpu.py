"""GPUSolver: the provisioning solve on the GPU, from a `SolverSnapshot` to
the scheduler's `Results` (new NodeClaims, pods on existing nodes, pod
errors), full or as a delta of the previous solve.

`solve(snap)` is the counterpart of the reference's default
`TPUSolver.solve` (solver/tpu.py:427-560, :636-686). Each solve is
flight-recorded: it begins a `SolveTrace` on the solver's recorder
(`obs/trace.py`) and commits it in a `finally`, so the trace holds the mode,
backend, span tree and attribution notes of every solve, and the commit
feeds the registry's counters and rolling quantiles. The body: encode the
snapshot with the solver's own `EncodeCache`; a snapshot with fallback
reasons takes the hybrid partitioned solve where its reasons are pod-local
(`_try_hybrid`: the in-window majority, masked out of the encoding, packs
on the device and the flagged residual runs the host FFD against its
result; a pod delta of the previous hybrid snapshot packs only the delta,
`_solve_masked_delta`), else the host FFD (`_fall_back`), as does an empty
snapshot; otherwise pack it on the device, as a delta of the resident carry
where the encoder linked it to the resident encoding, else in full; then
`_finish`: the relaxation check, `fast_validate`, the decode into node
claims (`_decode`, with the slot-reuse memo of the previous decode unless
`KARPENTER_SOLVER_FASTDECODE` is off, and the minValues repair through
`ffd.solve_residual`) and, only after a successful
decode, the resident carry for the next delta (dropped again after a
repair).

A solve that raises takes the reference's recovery ladder (`_recover`): a
quarantined full re-encode, then the host FFD. Unlike the reference, a
kernel's failure is never absorbed: a failed nvcc build or library load, a
kernel launch's error code (`kernels.build.KernelError`) and a CUDA error
raised by torch on the solve's device propagate, so the host FFD never
answers for a broken kernel.

The pack is the counterpart of `_solve_full` / `_solve_delta_inner`
(:688-718, :994-1196): build the work items and the device tensors, pack
(kernels K1 -> K2 -> K3), retry with an uncapped slot axis on overflow,
spread each item's pods over its slots and self-check the placement with
`fast_validate`. A delta applies the bind flush's row diff, re-credits
removed pods (kernel K4), rebuilds keyed-anti counts and port planes where a
removal needs it, packs only the added pods from the carry, merges the
assignment and validates the whole placement. Where the reference gives up
on the delta it records why (`last_delta_reject`) and the full pack runs.

The trace's spans carry the reference's names (`encode`, `pack`,
`validate`, `decode`, `residual`, `fallback`); the port's finer stages
(`PORT_SPANS`) are child spans inside them.

`GPUSolver(mesh=...)` (reference :253-262, :337-365) packs in full on a
mesh of shards (`parallel/sharded.py`): "auto", the default, follows
`default_mesh()` (`KARPENTER_SOLVER_MESH`), and is None (the single-device
path) on one card, and over distinct cards until their exchange exists
(ROADMAP Queue 1 item 9); an explicit such mesh raises. The meshed full
pack pads the slot axis to a mesh multiple, runs K1 once per shard and the
slot-sharded K2 under a `shard_exchange` span, and keeps its carry per
shard; a delta gathers it once and runs the single-device path over it.

`solve_prepared(snap, enc)` packs an encoding derived outside the solver
(a consolidation probe's masked sub-encode) in full, flight-recorded as
mode "sim", and leaves the warm state of the provisioning solves as it
found it.

`solve_encoded(problem)` runs the same pack on an `EncodedProblem` and
returns the validated placement (`PackResult`) without decoding; it keeps
its carry as soon as the placement validates.

`global_repack_plan(candidates, instance_types, pending_pods, seed)` is the
reference's global repack proposal pass (K5, K6) for serving's callers (the
churn harness's revocation recovery, the fleet's rebalance probe).
`configure_compile_cache()` is the counterpart of the reference's
persistent compilation cache: `KARPENTER_SOLVER_COMPILE_CACHE=<dir>` becomes
the kernels' build directory.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import metrics as m
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
    demotion_label,
    greedy_pack_delta_compressed,
    greedy_pack_grouped_compressed,
    item_pad_targets,
    make_item_tensors,
    pad_item_arrays,
    recredit_removals,
    sig_demotions,
)
from ..kernels.build import device_fault
from ..obs.trace import SolveTrace, default_recorder
from ..parallel.sharded import (
    ShardedState,
    default_mesh,
    greedy_pack_compressed_sharded,
    mesh_device,
    on_one_device,
    pad_slots_for_mesh,
    same_device,
)
from ..scheduling.hostports import pod_host_ports as _php
from ..scheduling.requirements import Operator, Requirement, Requirements
from ..utils import resources as res
from ..utils.quantity import Quantity
from .carry import apply_row_diff, rebuild_port_planes, recount_anti_groups
from .check import fast_validate
from .contracts import maybe_check_encoded
from .encode import EncodeCache, encode, hybrid_partition, mask_encode
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
from .ffd import FFDSolver, solve_residual
from .snapshot import SolverSnapshot

SLOT_CAP = 4096  # slot axis = n_existing + min(n_pods, SLOT_CAP) before the retry

# why a delta-capable solve took the full pack (the reference's strings)
DELTA_REJECT_REASONS = ("no-carry", "irreversible", "slot-exhausted", "validate")

# the recovery ladder's bounded `stage` enum (karpenter_solver_recovery_total):
# a failed solve retries as a full re-encode with every cross-solve cache
# quarantined; a failed retry degrades to the exact host FFD
RECOVERY_STAGES = ("full-reencode", "host-ffd")

# metric families that carry the fleet tenant label when one is set
_TENANT_LABELED = frozenset({m.SOLVER_SOLVE_TOTAL})

# the port's own stages, recorded as child spans inside the reference's
# spans (a trace's tree without them is the reference's tree)
PORT_SPANS = frozenset({"copy", "build_items", "make_tensors", "scan", "assignment", "carry_edits", "recredit",
                        "item_build", "merge", "delta_validate", "mask_encode", "seam_records", "ffd_adopt",
                        "ffd_prepare", "ffd_queue", "ffd_finalize", "gc2"})
# the port's own trace notes (the reference's trace has none of them)
PORT_NOTES = frozenset({"ffd_spread_skip"})


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


def _fastdecode_enabled() -> bool:
    """KARPENTER_SOLVER_FASTDECODE (default on): on delta solves, reuse the
    previous decode's per-slot materializations for slots whose assignment
    rows did not change. "0", "false" or "off" is the reference's exact arm:
    every slot re-materializes from scratch, the memo is neither read nor
    saved. The Results are identical in both arms."""
    return os.environ.get("KARPENTER_SOLVER_FASTDECODE", "1").strip().lower() not in ("0", "false", "off")


class _NullTopology:
    """Decode-time stand-in: claims are fully determined by the device result."""

    def register(self, *a, **k):
        pass

    def record(self, *a, **k):
        pass

    def add_requirements(self, *a, **k):  # pragma: no cover - not used in decode
        return Requirements()


def configure_compile_cache() -> str | None:
    """Claim ``KARPENTER_SOLVER_COMPILE_CACHE=<dir>`` as the kernels' build
    directory (`kernels.build.set_build_dir`): returns the dir, or None when
    unset or unwritable. The counterpart of the reference's persistent
    compilation cache: with the dir set, a RESTARTED process — or a fresh
    fleet replica or shard worker on the same volume — loads the built
    kernel library instead of running nvcc again.

    RACE-SAFE multi-process init (shardfleet): N shard processes point at
    the same dir concurrently at startup. makedirs is idempotent, and the
    stamp file is claimed with O_CREAT|O_EXCL so exactly ONE process is the
    first writer — everyone else adopts the established dir; the build
    itself runs under a file lock in the dir (`kernels.build.build`), so
    nvcc runs once however many processes start together. An unwritable dir
    means no shared cache, never an error."""
    global _COMPILE_CACHE_DIR
    from ..kernels import build as kbuild

    path = os.environ.get("KARPENTER_SOLVER_COMPILE_CACHE", "").strip()
    if not path or _COMPILE_CACHE_DIR == path:
        return _COMPILE_CACHE_DIR
    try:
        os.makedirs(path, exist_ok=True)
        fd = os.open(os.path.join(path, ".karpenter-cache-stamp"), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        try:
            os.write(fd, f"pid={os.getpid()}\n".encode())
        finally:
            os.close(fd)
    except FileExistsError:
        pass  # another process won the first-writer claim: adopt its dir
    except OSError:
        return None  # unwritable cache dir: build in the default dir
    kbuild.set_build_dir(path)
    _COMPILE_CACHE_DIR = path
    return path


_COMPILE_CACHE_DIR: str | None = None


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
    where the solve would otherwise fall back to the host FFD, and disables
    the recovery ladder, as does `recover=False`.

    `registry` (a `metrics.Registry`) receives the reference's solver
    counters with the backend label "gpu" where the reference writes "tpu";
    `recorder` (an `obs.trace.TraceRecorder`, the process-wide default when
    None) receives one `SolveTrace` per solve; `tenant` is the fleet tenant
    label of the solve counter. `fault_hook`, when set, is called with
    "solve" before each attempt and "reencode" before the ladder's retry
    (fault injection). With `stage_times=True` the device is synchronised at
    every span edge, so the spans time the device work they launch.

    After a solve: `last_solve_mode` is "full", "delta", "hybrid",
    "hybrid-delta", "sim" (`solve_prepared`) or "fallback" and
    `last_stages` its spans' ms by name, both read from the newest trace;
    `last_backend` is "gpu" (the reference's "tpu"), "hybrid" or
    "ffd-fallback"; `last_fallback_reasons` lists why the tensor path could
    not take the snapshot and `last_fallback_family` their bounded family
    (the fallback metric label); `last_delta_reject` names why the last
    solve did not take the delta path (None when it did); `last_decode`
    says how the decode went (mode "full" or "delta-reuse", reused and
    dirty slots)."""

    name = "gpu"

    def __init__(self, device=None, force: bool = False, stage_times: bool = False, registry=None, recorder=None,
                 tenant: str = "", recover: bool = True, mesh="auto"):
        self.device = resolve_device(device)
        # the meshed pack (reference tpu.py:253-262): "auto" resolves through
        # default_mesh() (None on one card); an explicit Mesh or None
        # overrides it. A mesh's shards lie on this solver's device. A mesh
        # over distinct cards has no exchange yet (ROADMAP Queue 1 item 9):
        # "auto" then takes the single-device path, an explicit one raises.
        if mesh == "auto":
            mesh = default_mesh()
            if mesh is not None and not on_one_device(mesh):
                mesh = None
        if mesh is not None and not same_device(mesh_device(mesh), self.device):
            raise ValueError(f"GPUSolver: the mesh's device {mesh.devices[0]} is not the solver's {self.device}")
        self.mesh = mesh
        self.force = force
        self.recover = recover
        self.fault_hook = None
        self.tenant = tenant
        self.registry = registry
        self.recorder = recorder if recorder is not None else default_recorder()
        self.fallback = FFDSolver()
        self.stage_times = stage_times
        self.encode_cache = EncodeCache()
        # pre-solve placeholder: the trace-derived surfaces read empty
        self._trace = SolveTrace(enabled=False)
        # podtrace linkage: the provisioner stages its event-batch summary
        # here right before the solve; the next begun trace notes it
        self._staged_event_batch: dict | None = None
        self.last_backend = ""
        self.last_fallback_reasons: list[str] = []
        self.last_fallback_family: str | None = None
        self.last_delta_reject: str | None = None
        self.last_decode: dict = {}
        # the previous solve's tensors, final pack carry (on the device) and
        # assignment, keyed by its problem (and, on the `solve` path, by its
        # encoding): a later delta packs only what changed from it
        self._resident: dict | None = None
        # the hybrid-delta carry: the previous hybrid solve's full encoding,
        # its masked (tensor-side) encoding and the signature partition; a
        # small pod delta of the same hybrid snapshot then packs only the
        # delta against the masked carry
        self._hybrid_state: dict | None = None
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

    # -- the trace-derived surfaces --------------------------------------------

    @property
    def last_solve_mode(self) -> str:
        return self._trace.mode

    @last_solve_mode.setter
    def last_solve_mode(self, value: str) -> None:
        self._trace.mode = value

    @property
    def last_phase_seconds(self) -> dict[str, float]:
        """Host wall-clock split of the last solve (the reference's view of
        the trace's phase totals)."""
        totals = self._trace.phase_totals
        return {k: totals.get(k, 0.0) for k in ("encode", "pack", "residual")}

    @property
    def last_stages(self) -> dict[str, float]:
        """Every span of the last solve, ms by name (summed over repeats)."""
        return {k: v * 1e3 for k, v in self._trace.phase_totals.items()}

    @contextmanager
    def _span(self, name: str, **attrs):
        """A span on the current trace; with `stage_times` the device is
        synchronised at both edges."""
        if self.stage_times:
            self._sync()
        with self._trace.span(name, **attrs) as sp:
            yield sp
            if self.stage_times:
                self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- counters ----------------------------------------------------------------

    def _count(self, metric: str, **labels) -> None:
        if self.registry is not None:
            if self.tenant and metric in _TENANT_LABELED:
                labels.setdefault("tenant", self.tenant)
            self.registry.counter(metric).inc(**labels)

    def _observe(self, metric: str, value: float, **labels) -> None:
        if self.registry is not None:
            self.registry.histogram(metric, labels=tuple(sorted(labels))).observe(value, **labels)

    def _note_item_info(self, info: dict) -> None:
        """Item-compression attribution of the grouped pack: pods per item,
        and the pods left one per item by bounded demotion reason."""
        self._trace.note(pack_items=info["n_items"], pack_pods=info["n_pods"],
                         item_demotions=dict(info["demotions"]))
        if self.registry is None:
            return
        for reason, pods in info["demotions"].items():
            self.registry.counter(m.SOLVER_PACK_ITEM_DEMOTIONS_TOTAL).inc(pods, reason=demotion_label(reason))
        if info["n_items"]:
            self.registry.gauge(m.SOLVER_PACK_ITEM_COMPRESSION).set(info["n_pods"] / max(info["n_items"], 1))

    def _note_delta_reject(self, reason: str) -> None:
        """Why a delta-capable solve took the full pack: on the solver, the
        trace and the per-reason counter."""
        self.last_delta_reject = reason
        self._trace.note(delta_reject=reason)
        self._count(m.SOLVER_DELTA_REJECT_TOTAL, reason=reason)  # solverlint: ok(metric-label-cardinality): reason is always a DELTA_REJECT_REASONS literal — enum-bounded at every producer (encode._try_delta_encode and the delta solve's reject sites)

    # -- the podtrace seam ---------------------------------------------------------

    def stage_event_batch(self, info: dict) -> None:
        """Attach the next solve's event-batch summary (the provisioner calls
        this after stamping dispatch on its batch)."""
        self._staged_event_batch = info

    def discard_event_batch(self) -> None:
        """Drop a staged event batch that no solve consumed."""
        self._staged_event_batch = None

    # -- the snapshot solve ----------------------------------------------------

    def solve(self, snap: SolverSnapshot) -> Results:
        """One provisioning solve, flight-recorded: snapshot in, `Results`
        out. Under ``KARPENTER_SOLVER_DETCHECK=1`` every solve also records
        a replayable dump of its inputs and its placement digest for
        `check_determinism` (obs/detcheck.py)."""
        from ..obs.detcheck import detcheck_enabled

        if not detcheck_enabled():
            return self._solve_flight(snap)
        from ..obs import detcheck

        blob = detcheck.dump_snapshot(snap, detcheck.solve_log(self).token_of)
        results = self._solve_flight(snap)
        detcheck.record_solve(self, blob, results)
        return results

    def check_determinism(self, clear: bool = True, timeout: float = 600.0) -> dict:
        """The dual-run determinism check: replay every recorded solve in a
        child process on this solver's device, under a perturbed
        PYTHONHASHSEED with every dict and set of the inputs re-inserted in
        reversed order, and compare placement digests. Raises
        `obs.detcheck.DetCheckError` on any divergence."""
        from ..obs import detcheck

        return detcheck.run_dual(self, timeout=timeout, clear=clear)

    @contextmanager
    def _flight(self, n_pods: int):
        """The solve's flight record (`TraceRecorder.flight`) with the
        per-solve surfaces reset before the body runs (a solve that raises
        past every exit path commits an empty record) and its backend and
        fallback reasons copied onto the trace before the commit."""
        with self.recorder.flight(n_pods=n_pods, registry=self.registry) as trace:
            self._trace = trace
            self.last_backend = ""
            self.last_fallback_reasons = []
            self.last_fallback_family = None
            self.last_delta_reject = None
            self.last_decode = {}
            try:
                yield trace
            finally:
                trace.backend = self.last_backend
                trace.fallback_reasons = list(self.last_fallback_reasons)

    def _device_fault(self, err: BaseException) -> bool:
        """A failure of the kernels or of the device (`build.device_fault`):
        a kernel's build, load, launch or argument refusal, or a CUDA error
        raised by torch on a CUDA solve."""
        return device_fault(err, self.device)

    def _solve_flight(self, snap: SolverSnapshot) -> Results:
        with self._flight(len(snap.pods)) as trace:
            staged, self._staged_event_batch = self._staged_event_batch, None
            if staged is not None:
                trace.note(event_batch=staged)
            try:
                hook = self.fault_hook
                if hook is not None:
                    hook("solve")
                return self._solve_inner(snap, trace)
            except Exception as e:
                # the degradation ladder; force-mode raise behavior, a
                # disabled ladder, unrecoverable faults and device faults
                # propagate
                if self.force or not self.recover or self._device_fault(e):
                    raise
                return self._recover(snap, trace, e)

    def quarantine_caches(self) -> None:
        """Drop every cross-solve artifact a failed solve may have poisoned:
        the EncodeCache (delta base and row cache), the device-resident pack
        carry, the hybrid carry and the decode memo. The next encode rebuilds
        everything from the live snapshot."""
        self.encode_cache = EncodeCache()
        self._resident = None
        self._hybrid_state = None
        self._decode_memo = None
        self._decode_delta_ctx = None
        self._resv_empty_memo = None

    def _recover(self, snap: SolverSnapshot, trace: SolveTrace, err: BaseException) -> Results:
        """The degradation ladder, entered only when a solve raised:

        1. full-reencode: quarantine every cross-solve cache and retry as a
           full encode and pack;
        2. host-ffd: if the retry raises too, quarantine again and serve the
           exact host FFD.

        Each step is noted on the trace (`recovery`, `recovery_error`) and
        counted in karpenter_solver_recovery_total{stage}. A device fault
        raised by the retry propagates."""
        self.quarantine_caches()
        trace.note(recovery_error=f"{type(err).__name__}: {err}"[:200])
        self._count(m.SOLVER_RECOVERY_TOTAL, stage="full-reencode")
        try:
            hook = self.fault_hook
            if hook is not None:
                hook("reencode")
            with self._span("encode", mode="full"):
                enc = encode(snap, cache=self.encode_cache)
            trace.n_sigs = int(getattr(enc, "n_sigs", 0) or 0)
            trace.note(recovery="full-reencode", encode_mode="full", row_cache=False)
            self.last_fallback_reasons = enc.fallback_reasons
            if enc.fallback_reasons or enc.n_pods == 0 or enc.n_rows == 0:
                route = (enc.fallback_reasons or ["empty snapshot"], None)
            else:
                self.last_solve_mode = "full"
                try:
                    results = self._solve_full_snapshot(snap, enc)
                    self._hybrid_state = None
                    return results
                except _TensorFallback as tf:
                    route = (tf.reasons, tf.family)
        except Exception as e2:
            if self._device_fault(e2):
                raise
            self.quarantine_caches()
            trace.note(recovery="host-ffd", recovery_error2=f"{type(e2).__name__}: {e2}"[:200])
            self._count(m.SOLVER_RECOVERY_TOTAL, stage="host-ffd")
            return self._fall_back(
                snap, [f"recovery: {type(err).__name__}", f"recovery-retry: {type(e2).__name__}"], family="recovery"
            )
        return self._fall_back(snap, route[0], family=route[1])

    def _solve_inner(self, snap: SolverSnapshot, trace: SolveTrace) -> Results:
        with self._span("encode") as sp:
            enc = encode(snap, cache=self.encode_cache)
        enc_mode = "delta" if getattr(enc, "encode_mode", "full") == "delta" else "full"
        sp.attrs["mode"] = enc_mode
        self._observe(m.SOLVER_ENCODE_SECONDS, sp.dur, mode=enc_mode)
        trace.n_sigs = int(getattr(enc, "n_sigs", 0) or 0)
        trace.note(encode_mode=enc_mode, row_cache=bool(getattr(enc, "row_cache_hit", False)))
        if enc_mode == "full":
            # the encoder's own reject reason (None on a cold encode)
            reject = self.encode_cache.last_delta_reject
            if reject is not None:
                self._note_delta_reject(reject)
        # consume and clear the delta link at once (even on the fallback
        # returns below): each link retains O(P) state
        delta_base = getattr(enc, "delta_base", None)
        if delta_base is not None:
            enc.delta_base = None
        self.last_fallback_reasons = enc.fallback_reasons
        if enc.fallback_reasons:
            if self.force:
                raise RuntimeError(f"tensor path unsupported: {enc.fallback_reasons}")
            hybrid = self._try_hybrid(snap, enc, delta_base)
            if hybrid is not None:
                return hybrid
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
            results = self._solve_full_snapshot(snap, enc)
            self._hybrid_state = None  # a full pack supersedes any hybrid carry
            return results
        except _TensorFallback as e:
            return self._fall_back(snap, e.reasons, family=e.family)

    def solve_prepared(self, snap: SolverSnapshot, enc) -> Results:
        """One flight-recorded full pack of an externally derived encoding
        (the consolidation simulator's masked sub-encodes,
        `encode.sim_mask_encode`), mode "sim". `snap` must be the true probe
        snapshot: a fallback re-solves it on the host FFD, so a masked solve
        never stands behind a placement the real snapshot would not give.
        The encode cache is not touched, and the provisioning warm state (the
        resident carry that the next `solve` or `solve_encoded` packs a delta
        from, the hybrid carry and the decode memo) is restored afterwards."""
        resident, hybrid_state, decode_memo = self._resident, self._hybrid_state, self._decode_memo
        with self._flight(len(enc.pods)) as trace:
            try:
                trace.n_sigs = int(getattr(enc, "n_sigs", 0) or 0)
                trace.note(encode_mode="sim-masked", row_cache=True)
                self.last_solve_mode = "sim"
                try:
                    return self._solve_full_snapshot(snap, enc)
                except _TensorFallback as e:
                    return self._fall_back(snap, e.reasons, family=e.family)
            finally:
                # the sim pack's carry describes the simulation, not the live
                # snapshot
                self._resident = resident
                self._hybrid_state = hybrid_state
                self._decode_memo = decode_memo

    def _fall_back(self, snap: SolverSnapshot, reasons: list[str], family: str | None = None) -> Results:
        self._hybrid_state = None  # the host result supersedes any hybrid carry
        self.last_backend = "ffd-fallback"
        self.last_solve_mode = "fallback"
        self.last_fallback_reasons = reasons
        if family is None:
            family = _reason_family(reasons[0]) if reasons else "empty"
        self.last_fallback_family = family
        self._count(m.SOLVER_FALLBACK_TOTAL, reason=family)  # solverlint: ok(metric-label-cardinality): family is a _reason_family() output, "empty", or a caller's literal ("validation"/"relaxation" from _TensorFallback, "recovery" from the ladder) — enum-bounded at every call site
        self._count(m.SOLVER_SOLVE_TOTAL, backend="ffd-fallback")
        # the host solve records its ffd.* phase split into this span
        # through the ambient current_trace()
        with self._span("fallback", reason=family):
            return self.fallback.solve(snap)

    def _solve_full_snapshot(self, snap: SolverSnapshot, enc, count: bool = True) -> Results:
        """One full pack and decode of `enc`. Raises _TensorFallback when the
        tensor path cannot stand behind the placement. `count=False`: the
        hybrid solve counts the merged solve itself."""
        # KARPENTER_SOLVER_TYPECHECK=1: the pack entry re-validates the
        # encoding's shape/dtype contracts
        maybe_check_encoded(enc, where="pack-full")
        with self._span("pack", mode="full"):
            with self._span("copy"):
                problem = from_reference(enc)
            pack = self._solve_full(problem)
            return self._finish(snap, enc, problem, pack, count=count)

    def _solve_delta(self, snap: SolverSnapshot, enc, base, count: bool = True) -> Results | None:
        """The delta solve from the resident carry when `base` (the encoder's
        delta link, or the encoding itself on an identical resubmit) is the
        resident encoding; None when the full pack must run."""
        resident = self._resident
        if resident is None:
            # the delta encode succeeded but the carry is gone (dropped after
            # a decode repair, or never kept): the full pack runs
            self._note_delta_reject("no-carry")
            return None
        if resident.get("enc") is not base:
            # the carry may be the masked pack of a previous hybrid solve
            # whose full encoding is `base`: continue there in masked
            # coordinates
            return self._solve_masked_delta(snap, enc, base)
        maybe_check_encoded(enc, where="pack-delta")
        with self._span("pack", mode="delta"):
            base_problem = resident["problem"]
            with self._span("copy"):
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
            info = pack.item_info
            self._trace.note(delta_added=info["n_added"], delta_removed=info["n_removed"],
                             delta_demoted=info["demoted"], row_refresh=info["row_refresh"])
            removed = problem.delta.removed_enc
            n_prev = problem.n_pods - int(problem.delta.added_sigs.shape[0])
            # this problem is the solver's own and the carry is keyed by
            # `enc`: drop its delta, and so its link to the base problem,
            # before `_finish` keeps it, or each resident problem would hold
            # every problem before it (each link retains O(P) state)
            problem.delta = None
            # decode-delta handoff: the validated assignment continues the
            # base decode's slot layout — tell _decode which base the memo
            # must match and which slots the delta touched (removed base
            # pods' slots + the appended tail's slots); everything else is
            # provably unchanged
            self._decode_delta_ctx = dict(
                base=base,
                removed=np.asarray(removed, dtype=np.int64) if removed.size else None,
                n_prev=n_prev,
            )
            return self._finish(snap, enc, problem, pack, validated=True, count=count)

    def _finish(self, snap, enc, problem: EncodedProblem, pack: PackResult, validated: bool = False,
                count: bool = True) -> Results:
        """The shared solve tail (full and delta): relaxation check,
        validation verdict, decode, the resident carry — kept only after a
        successful decode, dropped after a minValues repair — and the solve
        counter. `validated=True`: the delta path validated before
        committing."""
        # tier-0 honored every soft constraint; an unplaced pod means the
        # host relaxation loop must take over
        if pack.relaxation_required:
            if self.force:
                raise RuntimeError("tier-0 solve left relaxable pods unplaced")
            raise _TensorFallback(["relaxation required: soft constraints unsatisfiable tier-0"], family="relaxation")
        violations = [] if validated else pack.errors
        if violations:
            self._count(m.SOLVER_VALIDATION_FAILURES_TOTAL)
            if self.force:
                raise RuntimeError(f"tensor placement failed validation: {violations}")
            raise _TensorFallback([f"validation: {v}" for v in violations], family="validation")
        try:
            with self._span("decode"):
                results = self._decode(snap, enc, pack.assignment, pack.slot_basis, pack.slot_zoneset)
        except DecodeError as e:
            self._count(m.SOLVER_VALIDATION_FAILURES_TOTAL)
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
        if count:
            self._count(m.SOLVER_SOLVE_TOTAL, backend="gpu")
        return results

    # -- the encoded solve -----------------------------------------------------

    def solve_encoded(self, problem: EncodedProblem) -> PackResult:
        """Solve from the resident carry when the problem is a delta of the
        resident problem (an identical resubmit, or a problem without a
        delta that is the resident one, revalidates from the carry), else
        the full pack. No decode: the carry is kept once the placement
        validates. Flight-recorded as mode "full" or "delta"."""
        with self._flight(int(problem.n_pods)):
            self.last_solve_mode = "full"
            self.last_backend = "gpu"
            resident = self._resident
            base = problem.delta.base if problem.delta is not None else problem
            if resident is None or resident["problem"] is not base:
                self._note_delta_reject("no-carry")
            else:
                with self._span("pack", mode="delta"):
                    pack = self._solve_delta_inner(problem, base)
                if pack is not None:
                    self.last_solve_mode = "delta"
                    self._keep_resident(problem, pack)
                    return pack
            with self._span("pack", mode="full"):
                pack = self._solve_full(problem)
            if not (pack.errors or pack.relaxation_required):
                self._keep_resident(problem, pack)
            return pack

    def global_repack_plan(self, candidates, instance_types, pending_pods=None, seed: int = 0):
        """One flight-recorded GLOBAL repack proposal pass
        (solver/consolidation.propose_subsets_global, kernels K5 and K6 on
        this solver's device): candidate retirement co-optimized with the
        given pending pods' placement in a single relaxed solve. Returns
        (subsets best-first, info) — PROPOSALS only; the caller owns exact
        validation before acting on any subset. The seam serving customers
        use (churn revocation recovery, fleet rebalance) without
        constructing a disruption controller (reference solver/tpu.py:601)."""
        from .consolidation import propose_subsets_global

        with self.recorder.flight(n_pods=len(pending_pods or ()), mode="consolidate", backend="globalpack",
                                  registry=self.registry) as trace:
            return propose_subsets_global(candidates, instance_types, pending_pods=pending_pods, seed=seed,
                                          device=self.device, trace=trace, sync=self.stage_times)

    def global_repack_plan_encoded(self, problem, seed: int = 0):
        """One flight-recorded global repack proposal pass on an encoded
        consolidation round (`solver.consolidation.ConsolidationProblem`,
        pending pods as extra classes): the counterpart of the reference's
        `TPUSolver.global_repack_plan`, mode "consolidate", backend
        "globalpack". Returns (subsets best-first, info); proposals only,
        exact validation is the caller's."""
        from .consolidation import propose_problem_global

        with self.recorder.flight(n_pods=int(round(float(problem.pend_npods))), mode="consolidate",
                                  backend="globalpack", registry=self.registry) as trace:
            return propose_problem_global(problem, self.device, seed=seed, trace=trace, sync=self.stage_times)

    def _keep_resident(self, problem: EncodedProblem, pack: PackResult, enc=None) -> None:
        self._resident = dict(problem=problem, enc=enc, t=pack.tensors, targets=pack.targets, state=pack.state,
                              assignment=np.asarray(pack.assignment), slot_basis=np.asarray(pack.slot_basis),
                              slot_zoneset=np.asarray(pack.slot_zoneset))

    # -- full ------------------------------------------------------------------

    def _solve_full(self, problem: EncodedProblem) -> PackResult:
        p = problem
        with self._span("build_items"):
            item_arrays, item_pods, info = build_items(p, with_info=True)
            items = make_item_tensors(item_arrays, self.device)
        self._note_item_info(info)
        cap = p.n_existing + min(p.n_pods, SLOT_CAP)
        with self._span("make_tensors"):
            t = make_tensors(p, self.device, n_slots=cap)
        t, out = self._pack(t, items, p.n_pods)
        if out["open_count"] == out["n_slots"] and int(out["leftovers"].sum()) > 0 and cap < p.n_existing + p.n_pods:
            t, out = self._pack(make_tensors(p, self.device), items, p.n_pods)
        with self._span("assignment"):
            assignment = assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], item_pods, p.n_pods)
        relax = bool(p.has_relaxable and (assignment < 0).any())
        with self._span("validate"):
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

    def _pack(self, t, items, n_pods: int):
        """The full pack, K1 -> K2 -> K3 (span `scan`). On a mesh of more
        than one shard (reference tpu.py:337-365): the slot axis padded to a
        mesh multiple, batch-sharded feasibility, the slot-sharded scan, then
        K3 over the gathered takes, under a `shard_exchange` span (its n_dev
        the mesh size). Returns (the tensors the pack and its carry are
        consistent with, its outputs)."""
        if self.mesh is None or self.mesh.size <= 1:
            with self._span("scan"):
                return t, greedy_pack_grouped_compressed(t, items, n_pods)
        t = pad_slots_for_mesh(t, self.mesh)
        with self._span("shard_exchange", n_dev=int(self.mesh.size)), self._span("scan"):
            return t, greedy_pack_compressed_sharded(t, items, n_pods, self.mesh)

    # -- delta -----------------------------------------------------------------

    def _solve_delta_inner(self, problem: EncodedProblem, base: EncodedProblem) -> PackResult | None:
        p = problem
        d = problem.delta
        resident = self._resident
        t = resident["t"]
        state = resident["state"]
        if isinstance(state, ShardedState):
            # a meshed pack's carry: the delta runs on the single-device path
            # over it, gathered once (the reference's delta over its sharded
            # carry, parallel/sharded.py:29-34)
            state = state.gather_state()
        prev_assignment = resident["assignment"]
        slot_basis = resident["slot_basis"]
        slot_zoneset = resident["slot_zoneset"]

        # bind flush: the carry and the resident tensors take the refreshed
        # existing rows, so they describe the state a fresh encode would
        row_diff = d.row_diff if d is not None else None
        rebuild_ports = bool(row_diff is not None and row_diff.ports_changed)
        if row_diff is not None:
            with self._span("carry_edits"):
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
                    self._note_delta_reject("irreversible")
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
                with self._span("recredit"):
                    state = recredit_removals(state, t, rslot[placed].astype(np.int32), p.sig_req[ps], zmem, hmem)
            keep = np.ones(prev_assignment.shape[0], dtype=bool)
            keep[removed] = False
            prev_assignment = prev_assignment[keep]

        n_surv = int(prev_assignment.shape[0])
        surv_sigs = np.asarray(p.sig_of_pod)[:n_surv]
        with self._span("carry_edits"):
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
            with self._span("item_build"):
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
            with self._span("scan"):
                out = greedy_pack_delta_compressed(state, t, items, n_added)
            # the compressed pack's outputs are parsed from its one download
            # (`_pack_flat`): leftovers is host numpy, open_count an int
            if out["open_count"] == t.n_slots and int(out["leftovers"][:W_real].sum()) > 0:  # solverlint: ok(host-sync-in-hot-path): host numpy, no device read
                self._note_delta_reject("slot-exhausted")
                return None
            with self._span("merge"):
                da = assignment_from_triples(out["nz_item"], out["nz_slot"], out["nz_count"], item_pods, p.n_pods)
                assignment = np.concatenate([prev_assignment, np.full(n_added, -1, dtype=np.int64)])
                assignment[da >= 0] = da[da >= 0]
            slot_basis = out["slot_basis"]
            slot_zoneset = out["slot_zoneset"]
        else:
            assignment = prev_assignment

        # a failed check retries the full pack fresh
        if p.has_relaxable and (assignment < 0).any():
            self._note_delta_reject("validate")
            return None
        with self._span("delta_validate"):
            errors = fast_validate(p, assignment, slot_basis, slot_zoneset)
        if errors:
            self._note_delta_reject("validate")
            return None
        state = out["state"]
        return PackResult(
            assignment=assignment,
            slot_basis=slot_basis,
            slot_zoneset=slot_zoneset,
            leftovers=out["leftovers"],
            open_count=int(out.get("open_count", state[6])),  # solverlint: ok(host-sync-in-hot-path): open_count is the parsed host int (the pack's dict always holds it)
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

    # -- the hybrid partitioned solve -------------------------------------------

    def _try_hybrid(self, snap: SolverSnapshot, enc, delta_base=None) -> Results | None:
        """Hybrid partitioned solve: when every fallback reason is pod-local
        and the flagged residual is constraint-independent of the rest
        (`encode.hybrid_partition`), pack the in-window majority on the
        device and run the exact host FFD on the residual only, against the
        tensor result's node state, so residual pods schedule into the
        freshly proposed claims instead of double-provisioning.

        The sub-encoding masks the full one (`encode.mask_encode`): no second
        encode, and the EncodeCache keeps the full encoding. When the
        snapshot is a small pod delta of the previous hybrid solve, the warm
        path packs only the delta against the kept masked carry
        (`_solve_masked_delta`, mode "hybrid-delta"). Returns the merged
        Results, or None when the whole snapshot must fall back."""
        # warm path: a pod delta of the previous hybrid snapshot (an
        # identical resubmit carries no link but is its own base)
        hs = self._hybrid_state
        base = delta_base if delta_base is not None else (enc if hs is not None and hs["full_enc"] is enc else None)
        if base is not None:
            warm = self._solve_masked_delta(snap, enc, base)
            if warm is not None:
                return warm

        part = hybrid_partition(snap, enc)
        if part is None:
            self._hybrid_state = None
            return None
        _tensor_pods, residual_pods = part
        keep = np.ones(enc.n_sigs, dtype=bool)
        keep[[int(s) for s in enc.fallback_sig_local]] = False
        masked = self._mask_encode(enc, keep)
        if masked.n_pods == 0 or masked.n_rows == 0:
            self._hybrid_state = None
            return None
        sub_snap = snap.with_pods(masked.pods)
        try:
            tensor_results = self._solve_full_snapshot(sub_snap, masked, count=False)
        except _TensorFallback:
            self._hybrid_state = None
            return None  # the tensor majority could not stand: the whole snapshot takes the host FFD
        remap = np.full(enc.n_sigs, -1, dtype=np.int32)
        remap[keep] = np.arange(int(keep.sum()), dtype=np.int32)
        # one full and one masked encoding, never their predecessors
        self._hybrid_state = dict(full_enc=enc, masked_enc=masked, keep=keep, remap=remap)
        return self._hybrid_residual(snap, enc, keep, residual_pods, tensor_results, "hybrid")

    def _hybrid_residual(self, snap: SolverSnapshot, enc, keep: np.ndarray, residual_pods: list,
                         tensor_results: Results, mode: str) -> Results:
        """The exact host FFD on the flagged residual against the tensor
        result's node state, with the spread counts across the seam; counts
        the merged solve under its mode."""
        self._trace.note(residual_pods=len(residual_pods))
        with self._span("residual"):
            with self._span("seam_records"):
                records = self._seam_records(enc, keep, tensor_results)
            results = solve_residual(snap, residual_pods, tensor_results, seam_records=records)
        self.last_backend = "hybrid"
        self.last_solve_mode = mode
        self.last_fallback_reasons = enc.fallback_reasons
        for family in sorted({_reason_family(r) for r in enc.fallback_reasons}):
            self._count(m.SOLVER_HYBRID_RESIDUAL_TOTAL, reason=family)
        self._count(m.SOLVER_SOLVE_TOTAL, backend=mode)  # solverlint: ok(metric-label-cardinality): mode is "hybrid" or "hybrid-delta", the literals of _hybrid_residual's two callers
        return results

    def _mask_encode(self, enc, keep: np.ndarray):
        """The tensor-side sub-encoding of a hybrid solve, timed as the
        reference's masked encode."""
        with self._span("encode", mode="masked") as sp:
            with self._span("mask_encode"):
                masked = mask_encode(enc, np.nonzero(keep)[0])
        self._observe(m.SOLVER_ENCODE_SECONDS, sp.dur, mode="masked")
        return masked

    def _solve_masked_delta(self, snap: SolverSnapshot, enc, base) -> Results | None:
        """Hybrid-delta: `enc` is a pod delta of `base`, the previous hybrid
        solve's full encoding, and the resident carry is that solve's masked
        (tensor-side) pack. The delta is translated into masked coordinates:
        tensor-side removals re-credit and tensor-side additions pack from
        the kept carry, while the small residual re-solves on the exact host
        path against the fresh tensor results. Returns the merged Results
        (mode "hybrid-delta"), the pure tensor Results when no flagged pod is
        left ("delta"), or None when the cold path must run."""
        hs = self._hybrid_state
        resident = self._resident
        if base is None:
            return None
        if hs is None or resident is None:
            self._note_delta_reject("no-carry")
            return None
        if hs["full_enc"] is not base or resident["enc"] is not hs["masked_enc"]:
            self._note_delta_reject("no-carry")
            return None
        if getattr(enc, "delta_row_diff", None) is not None:
            # a row-refresh diff cannot be applied to the masked carry
            # untranslated (the encoder routes a hybrid base full on one;
            # this guards any other arrival path)
            self._note_delta_reject("no-carry")
            return None
        keep = hs["keep"]  # bool [S] over the full encoding's signature axis
        if enc.n_sigs != keep.shape[0] or enc.fallback_has_global:
            # a grown signature axis or a snapshot-global reason: the kept
            # partition no longer describes this snapshot
            self._note_delta_reject("no-carry")
            return None
        # the delta's attribution must stay inside the kept partition: a
        # newly flagged tensor-side signature would invalidate the split
        if any(keep[int(s)] for s in enc.fallback_sig_local):
            self._note_delta_reject("fallback-global")
            return None
        masked_base = hs["masked_enc"]
        remap = hs["remap"]

        removed = getattr(enc, "delta_removed_enc", None)
        if removed is not None and removed.size:
            base_keep_pod = keep[np.asarray(base.sig_of_pod)]
            masked_pos = np.cumsum(base_keep_pod) - 1
            tensor_removed = removed[base_keep_pod[removed]]
            masked_removed = masked_pos[tensor_removed].astype(np.int64)
        else:
            masked_removed = np.zeros(0, np.int64)
        added_sigs = getattr(enc, "delta_added_sigs", None)
        if added_sigs is None or not added_sigs.size:
            masked_added = np.zeros(0, np.int32)
        else:
            masked_added = remap[added_sigs[keep[added_sigs]]].astype(np.int32)

        masked_new = self._mask_encode(enc, keep)
        if masked_new.n_pods == 0:
            return None
        masked_new.delta_removed_enc = masked_removed
        masked_new.delta_added_sigs = masked_added
        sub_snap = snap.with_pods(masked_new.pods)
        try:
            tensor_results = self._solve_delta(sub_snap, masked_new, masked_base, count=False)
        except _TensorFallback:
            return None  # the cold hybrid (or the whole-snapshot fallback) takes over
        if tensor_results is None:
            return None
        pod_flagged = ~keep[np.asarray(enc.sig_of_pod)]
        residual_pods = [p for p, f in zip(enc.pods, pod_flagged) if f]
        self._hybrid_state = dict(full_enc=enc, masked_enc=masked_new, keep=keep, remap=remap)
        if not residual_pods:
            # the out-of-window pods left the snapshot: a pure tensor delta
            self.last_solve_mode = "delta"
            self._count(m.SOLVER_SOLVE_TOTAL, backend="gpu")
            return tensor_results
        return self._hybrid_residual(snap, enc, keep, residual_pods, tensor_results, "hybrid-delta")

    # -- the topology export across the seam -----------------------------------

    @staticmethod
    def _seam_records(enc, keep: np.ndarray, tensor_results: Results, require_cross: bool = True,
                      all_kinds: bool = False) -> list:
        """Exported topology group counts: (pod, taints, requirements) per
        tensor-placed pod that a group spanning the residual seam counts,
        for `ffd.solve_residual` to record into the residual Topology.

        `hybrid_partition` lets spread groups span the partition because of
        this export: the residual scheduler's per-placement skew rule must
        run against the true combined per-domain occupancy, and tensor-placed
        pods are pending (invisible to store-side counting). Each record
        carries the placement's CONCRETE requirements — the claim's (with its
        committed domain pin and adopted hostname) or the existing node's
        label view — so the host's own counting rule (selector + node filter
        + single-value domain) applies unchanged. Empty whenever no group
        touches both sides, which keeps the common case free.

        The minValues repair passes `require_cross=False, all_kinds=True`: a
        repair splits CLAIMS (not whole signatures), so a group touching
        only the repaired signatures still has surviving placements the
        repair must see, and repaired pods can belong to any group kind —
        `Topology.record` applies the host counting semantics per kind."""
        if not enc.n_groups:
            return []
        kinds = np.asarray(enc.group_kind)
        sel = np.ones(kinds.shape[0], dtype=bool) if all_kinds else ((kinds == KIND_DOM_SPREAD) | (kinds == KIND_HOST_SPREAD))
        if not sel.any():
            return []
        touches = enc.sig_member | enc.sig_owner
        cross = sel & touches[~keep].any(axis=0)
        if require_cross:
            cross &= touches[keep].any(axis=0)
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
            for pod in en.pods:  # solverlint: ok(python-loop-over-pod-axis): gated — reached only when a topology group spans the hybrid seam (early-returns above keep the common case free), and record-building is irreducibly per-pod
                s = sig_of.get(id(pod))
                if s is not None and seam_sig[s]:
                    # decode-built ExistingNode requirements are the node's
                    # label view + hostname — exactly what record() needs
                    records.append((pod, en.taints, en.requirements))
        for nc in tensor_results.new_node_claims:
            for pod in nc.pods:  # solverlint: ok(python-loop-over-pod-axis): gated — same seam-export bound as the existing-node walk above
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
        fastdecode = _fastdecode_enabled()
        delta_ctx, self._decode_delta_ctx = self._decode_delta_ctx, None
        memo, self._decode_memo = (self._decode_memo if fastdecode else None), None

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
        # reused slots, fresh entries for materialized ones); off with the
        # switch off or under reservations
        save_new: dict[int, dict] | None = {} if fastdecode and reservation_manager is None else None
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

        decode_mode = "delta-reuse" if reused_slots else "full"
        self.last_decode = dict(mode=decode_mode, reused_slots=reused_slots, dirty_slots=len(pods_by_slot))
        self._trace.note(decode_mode=decode_mode, decode_reused_slots=reused_slots,
                         decode_dirty_slots=len(pods_by_slot))
        self._count(m.SOLVER_DECODE_TOTAL, mode=decode_mode)
        if reused_slots and self.registry is not None:
            self.registry.counter(m.SOLVER_DECODE_REUSED_SLOTS_TOTAL).inc(reused_slots)
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
            self._decode_repaired = True
            self.last_decode.update(repair_pods=len(repair_pods), repair_sigs=len(repair_sigs))
            self._count(m.SOLVER_DECODE_REPAIR_TOTAL, reason="min-values")
            self._trace.note(repair_pods=len(repair_pods), repair_sigs=len(repair_sigs), repair_reason="min-values")
            keep = np.ones(enc.n_sigs, dtype=bool)
            keep[sorted(repair_sigs)] = False
            results = solve_residual(
                snap, repair_pods, results,
                seam_records=self._seam_records(enc, keep, results, require_cross=False, all_kinds=True),
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
