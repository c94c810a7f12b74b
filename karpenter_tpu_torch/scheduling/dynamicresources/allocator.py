"""DRA device allocator: DFS assignment of devices to claim requests.

Reference: pkg/scheduling/dynamicresources/{allocator,pool,request,constraint,
allocationtracker}.go — the reference walks a decision tree over (request x
candidate device) choices under a 5s/pod budget (allocator.go:41-43), tracking
already-allocated devices and enforcing matchAttribute constraints, against
two device sources: ResourceSlices published in-cluster (existing nodes) and
*template* devices an instance type would ship if launched
(cloudprovider.InstanceType.DynamicResources, types.go:133-135).

TPU-native redesign notes: the CEL selector language is replaced by structured
selector dicts ({attribute|capacity, operator, values}) evaluated host-side —
device selection is control-plane work and stays off the device; the tensor
solver falls back to FFD for claim-bearing pods (encode.py). Partitionable
devices are modeled via pool-level shared counter sets
(partitionable_devices.go): devices declare consumes_counters, pools declare
shared_counters (in-cluster slices) or dynamic_resources_counters (instance
type templates, fresh per launched node), and the tracker draws down lazily-
materialized per-candidate remaining budgets. Per-instance-type requirement
SUPERPOSITION (allocator.go:90-134) is modeled by
superpose_template_allocation: each instance type's device choice contributes
the node requirements its devices pin (Device.requirements), a claim's
topology is pessimistically the intersection across surviving types
(ClaimAllocationMetadata.total), and types that would collapse any claim's
intersection to the empty set are pruned.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field

from ...utils.quantity import Quantity
from .cel import matches_device as _cel_matches

ALLOCATE_TIMEOUT_SECONDS = 5.0  # allocator.go:43


# -- selectors ---------------------------------------------------------------
def _attr_value(device, name):
    if name in device.attributes:
        return device.attributes[name]
    # allow unqualified lookup of "driver/attr" names
    for k, v in device.attributes.items():
        if k.split("/")[-1] == name:
            return v
    return None


def device_matches_selectors(device, selectors: list[dict], driver: str = "") -> bool:
    """Structured replacement for the reference's CEL device selectors
    (request.go Selectors): every selector must match. A selector may also be
    a CEL expression `{"cel": "<expr>"}` evaluated by the subset interpreter
    in cel.py, so reference ResourceClaims port over verbatim
    (allocator_test.go exactRequestWithSelector corpus); `driver` feeds
    `device.driver` there."""
    for sel in selectors or []:
        if "cel" in sel:
            if not _cel_matches(sel["cel"], device, driver):
                return False
        elif "attribute" in sel:
            val = _attr_value(device, sel["attribute"])
            op = sel.get("operator", "Exists")
            values = sel.get("values", [])
            if op == "Exists":
                if val is None:
                    return False
            elif op == "DoesNotExist":
                if val is not None:
                    return False
            elif op == "In":
                if val is None or str(val) not in [str(v) for v in values]:
                    return False
            elif op == "NotIn":
                if val is not None and str(val) in [str(v) for v in values]:
                    return False
            elif op in ("Gt", "Lt", "Gte", "Lte"):
                if val is None:
                    return False
                try:
                    v, bound = float(val), float(values[0])
                except (TypeError, ValueError, IndexError):
                    return False
                if op == "Gt" and not v > bound:
                    return False
                if op == "Lt" and not v < bound:
                    return False
                if op == "Gte" and not v >= bound:
                    return False
                if op == "Lte" and not v <= bound:
                    return False
            else:
                return False
        elif "capacity" in sel:
            cap = device.capacity.get(sel["capacity"])
            if cap is None:
                return False
            bound = Quantity.parse(sel.get("value", "0"))
            op = sel.get("operator", "Gte")
            if op == "Gte" and not cap.milli >= bound.milli:
                return False
            if op == "Lte" and not cap.milli <= bound.milli:
                return False
        else:
            return False
    return True


# -- claims ------------------------------------------------------------------
def resolve_pod_claims(store, pod):
    """The pod's ResourceClaims, materializing template-backed ones with the
    kube naming convention <pod>-<claim entry name> when the object already
    exists, else a synthetic claim from the template (utils/resourceclaim).
    Returns (claims, err)."""
    from ...kube.objects import ObjectMeta, ResourceClaim

    claims = []
    for entry in pod.spec.resource_claims:
        if entry.get("resourceClaimName"):
            rc = store.try_get("ResourceClaim", entry["resourceClaimName"], pod.metadata.namespace)
            if rc is None:
                return None, f"resourceclaim {entry['resourceClaimName']} not found"
            claims.append(rc)
        elif entry.get("resourceClaimTemplateName"):
            name = f"{pod.metadata.name}-{entry.get('name', '')}"
            rc = store.try_get("ResourceClaim", name, pod.metadata.namespace)
            if rc is not None:
                claims.append(rc)
                continue
            tmpl = store.try_get("ResourceClaimTemplate", entry["resourceClaimTemplateName"], pod.metadata.namespace)
            if tmpl is None:
                return None, f"resourceclaimtemplate {entry['resourceClaimTemplateName']} not found"
            claims.append(
                ResourceClaim(
                    metadata=ObjectMeta(name=name, namespace=pod.metadata.namespace),
                    requests=copy.deepcopy(tmpl.requests),
                    constraints=copy.deepcopy(tmpl.constraints),
                )
            )
    return claims, None


@dataclass
class _DeviceRef:
    """A concrete candidate device with its identity for tracking."""

    device: object
    driver: str
    pool: str
    device_id: tuple  # (scope, driver, pool, name); scope=node name or "template"


@dataclass
class AllocationResult:
    """Successful allocation: per-claim device picks (allocator.go:182-191)."""

    # claim key -> [(request name, _DeviceRef, consumed capacity | None)]
    picks: dict = field(default_factory=dict)
    # the claims this allocation served (for superposition re-allocation)
    claims: list = field(default_factory=list)


@dataclass
class ClaimAllocationMetadata:
    """Per-claim allocation state for template-device allocations
    (allocator.go:90-134 ResourceClaimAllocationMetadata): the NodeClaim the
    claim is transitively bound to, the requirements each instance type's
    device choice CONTRIBUTES, and their pessimistic intersection — the
    topology the claim is treated as pinned to while the NodeClaim stays
    superposed across instance types."""

    node_claim_id: str = ""
    used_template_devices: bool = False
    contributed: dict = field(default_factory=dict)  # it name -> Requirements
    devices: dict = field(default_factory=dict)  # it name -> picks
    total: object = None  # Requirements — intersection of contributed

    def recompute_total(self):
        from ...scheduling.requirements import Requirements

        total = Requirements()
        for reqs in self.contributed.values():
            total.add(*reqs.values())
        self.total = total
        return total


_SUPPORTED_DEVICE_REQ_OPS = {"In", "NotIn", "Gt", "Lt", "Exists"}


def _device_requirements(device) -> list:
    """The node requirements one device pins, as Requirement objects.
    Only value/bound operators are supported — an absence operator
    (DoesNotExist) on a device requirement is ignored at ingestion, because
    a collapsed intersection also renders as DoesNotExist and the two would
    be indistinguishable to the pruning check."""
    from ...scheduling.requirements import Requirement

    out = []
    for r in getattr(device, "requirements", None) or []:
        op = r.get("operator", "In")
        if op not in _SUPPORTED_DEVICE_REQ_OPS:
            continue
        out.append(Requirement(r["key"], op, r.get("values", [])))
    return out


def requirements_from_picks(picks) -> "Requirements":
    """The node requirements a device selection pins: every chosen device's
    `requirements` land on ONE node, so they intersect (Requirements.add)."""
    from ...scheduling.requirements import Requirements

    out = Requirements()
    for _name, ref, _cap in picks:
        out.add(*_device_requirements(ref.device))
    return out


def _requirements_satisfiable(reqs) -> bool:
    """False when any requirement's allowed set is empty (the intersection
    collapsed — allocator.go prunes such instance types). Device
    contributions are In/NotIn value sets over labels a launched node
    carries, so an intersection that renders as DOES_NOT_EXIST (empty
    allowed set) is a contradiction, not a real absence requirement."""
    from ...scheduling.requirements import Operator

    for r in reqs.values():
        if r.operator() in (Operator.IN, Operator.DOES_NOT_EXIST) and not r.complement and not r.values:
            return False
        # numeric-bound collapse: Gt/Lt contributions whose intersection
        # leaves gte > lte match nothing
        if r.gte is not None and r.lte is not None and r.gte > r.lte:
            return False
    return True


class _MatchAttributeConstraint:
    """All devices for the constrained requests share the attribute's value
    (constraint.go:41-146)."""

    def __init__(self, attribute: str, requests: list[str] | None):
        self.attribute = attribute
        self.requests = set(requests) if requests else None  # None = all
        self.value = None
        self.count = 0

    def applies(self, request_name: str) -> bool:
        return self.requests is None or request_name in self.requests

    def add(self, request_name: str, device) -> bool:
        if not self.applies(request_name):
            return True
        val = _attr_value(device, self.attribute)
        if val is None:
            return False
        if self.count == 0:
            self.value = val
            self.count = 1
            return True
        if val != self.value:
            return False
        self.count += 1
        return True

    def remove(self, request_name: str) -> None:
        if not self.applies(request_name):
            return
        self.count -= 1
        if self.count == 0:
            self.value = None


def _norm_counters(counters: dict) -> dict:
    return {k: (v if isinstance(v, Quantity) else Quantity.parse(v)) for k, v in (counters or {}).items()}


def _budget_from_sets(counter_sets: list[dict]) -> dict:
    """[{"name", "counters"}] -> {set name: {counter name: Quantity}}."""
    return {cs.get("name", ""): _norm_counters(cs.get("counters")) for cs in counter_sets or []}


class AllocationTracker:
    """Devices already spoken for: exclusive allocations, consumed capacity of
    multi-allocatable devices, and remaining shared-counter budgets of
    partitionable-device pools (allocationtracker.go +
    partitionable_devices.go). `budgets` is a shared read-only registry of
    pool counter budgets (pool key -> {set: {counter: Quantity}}); a pool's
    remaining state materializes lazily on first touch so per-candidate
    trackers each draw down their own copy."""

    def __init__(self, budgets: dict | None = None):
        self.exclusive: set = set()  # device ids
        self.consumed: dict = {}  # device id -> {capacity name: Quantity}
        self.budgets = budgets if budgets is not None else {}
        self.remaining_counters: dict = {}  # pool key -> {set: {counter: Quantity}}

    def copy(self) -> "AllocationTracker":
        c = AllocationTracker(budgets=self.budgets)
        c.exclusive = set(self.exclusive)
        c.consumed = {k: dict(v) for k, v in self.consumed.items()}
        c.remaining_counters = {pk: {cs: dict(cn) for cs, cn in sets.items()} for pk, sets in self.remaining_counters.items()}
        return c

    def _remaining_for(self, pool_key: tuple) -> dict | None:
        rem = self.remaining_counters.get(pool_key)
        if rem is None:
            budget = self.budgets.get(pool_key)
            if budget is None:
                return None  # pool declares no counter sets: unconstrained
            rem = {cs: dict(cn) for cs, cn in budget.items()}
            self.remaining_counters[pool_key] = rem
        return rem

    def _counters_available(self, ref: "_DeviceRef") -> bool:
        consumption = getattr(ref.device, "consumes_counters", None)
        if not consumption:
            return True
        rem = self._remaining_for(ref.device_id[:3])
        if rem is None:
            return True
        for cc in consumption:
            counter_set = rem.get(cc.get("counterSet", ""))
            if counter_set is None:
                return False  # consuming from an undeclared set: never fits
            for name, want in _norm_counters(cc.get("counters")).items():
                have = counter_set.get(name)
                if have is None or have.milli < want.milli:
                    return False
        return True

    def _counters_apply(self, ref: "_DeviceRef", sign: int) -> None:
        consumption = getattr(ref.device, "consumes_counters", None)
        if not consumption:
            return
        rem = self._remaining_for(ref.device_id[:3])
        if rem is None:
            return
        for cc in consumption:
            counter_set = rem.get(cc.get("counterSet", ""))
            if counter_set is None:
                continue
            for name, want in _norm_counters(cc.get("counters")).items():
                if name in counter_set:
                    counter_set[name] = counter_set[name] + Quantity(sign * want.milli)

    def available(self, ref: _DeviceRef, want_capacity: dict) -> bool:
        if ref.device_id in self.exclusive:
            return False
        if not self._counters_available(ref):
            return False
        if not ref.device.allow_multiple_allocations:
            return True
        used = self.consumed.get(ref.device_id, {})
        for name, want in (want_capacity or {}).items():
            have = ref.device.capacity.get(name)
            if have is None:
                return False
            already = used.get(name, Quantity(0))
            if already.milli + want.milli > have.milli:
                return False
        return True

    def take(self, ref: _DeviceRef, want_capacity: dict) -> None:
        self._counters_apply(ref, -1)
        if ref.device.allow_multiple_allocations:
            used = self.consumed.setdefault(ref.device_id, {})
            for name, want in (want_capacity or {}).items():
                used[name] = used.get(name, Quantity(0)) + want
        else:
            self.exclusive.add(ref.device_id)

    def release(self, ref: _DeviceRef, want_capacity: dict) -> None:
        self._counters_apply(ref, 1)
        if ref.device.allow_multiple_allocations:
            used = self.consumed.get(ref.device_id, {})
            for name, want in (want_capacity or {}).items():
                if name in used:
                    used[name] = used[name] - want
        else:
            self.exclusive.discard(ref.device_id)


class Allocator:
    """One scheduling loop's allocator: shared read-mostly state plus
    per-candidate trackers (allocator.go:45-67)."""

    def __init__(self, store, clock=None):
        self.store = store
        # the DFS deadline uses the injected clock when it measures real time
        # (production Clock); a FakeClock only advances when tests step it, so
        # the timeout path is test-controllable (allocator.go:41-43)
        self.clock = clock
        self.class_selectors: dict[str, list[dict]] = {
            dc.metadata.name: dc.selectors for dc in store.list("DeviceClass")
        }
        # node name -> [_DeviceRef] from in-cluster ResourceSlices; pool
        # counter budgets from slices' SharedCounters (partitionable devices)
        self.node_devices: dict[str, list[_DeviceRef]] = {}
        self.counter_budgets: dict[tuple, dict] = {}  # pool key -> {set: {counter: Quantity}}
        for sl in store.list("ResourceSlice"):
            if not sl.node_name:
                continue  # selector-scoped slices not modeled; see module doc
            refs = self.node_devices.setdefault(sl.node_name, [])
            for d in sl.devices:
                refs.append(
                    _DeviceRef(device=d, driver=sl.driver, pool=sl.pool_name,
                               device_id=(sl.node_name, sl.driver, sl.pool_name, d.name))
                )
            if getattr(sl, "shared_counters", None):
                pool_key = (sl.node_name, sl.driver, sl.pool_name)
                budget = self.counter_budgets.setdefault(pool_key, {})
                budget.update(_budget_from_sets(sl.shared_counters))
        # seed allocated-device state from in-cluster claim statuses
        self.base_tracker = AllocationTracker(budgets=self.counter_budgets)
        _id_to_ref = {r.device_id: r for refs in self.node_devices.values() for r in refs}
        self.allocated_claims: dict[str, dict] = {}  # claim key -> allocation
        for rc in store.list("ResourceClaim"):
            alloc = rc.status.allocation
            if not alloc:
                continue
            self.allocated_claims[rc.key()] = alloc
            node = alloc.get("nodeName", "")
            for dev in alloc.get("devices", []):
                did = (node, dev.get("driver", ""), dev.get("pool", ""), dev.get("device", ""))
                consumed = dev.get("consumedCapacity")
                if consumed:
                    used = self.base_tracker.consumed.setdefault(did, {})
                    for name, q in consumed.items():
                        q = q if isinstance(q, Quantity) else Quantity.parse(q)
                        used[name] = used.get(name, Quantity(0)) + q
                elif dev.get("multiAllocatable"):
                    # a capacity-less allocation on a shareable device consumes
                    # nothing — marking it exclusive would silently flip the
                    # device to single-claim once the status persists
                    pass
                else:
                    self.base_tracker.exclusive.add(did)
                # pre-allocated partitionable devices consumed their pool's
                # counter budget (partitionable_devices.go InitRemainingCounters)
                ref = _id_to_ref.get(did)
                if ref is not None and getattr(ref.device, "consumes_counters", None):
                    self.base_tracker._counters_apply(ref, -1)
        # in-loop committed picks layered on top of the base state
        self.loop_tracker = self.base_tracker.copy()
        # claim key -> node/claim target committed this loop (shared claims
        # must co-locate all their pods)
        self.claim_targets: dict[str, str] = {}
        # claim key -> ClaimAllocationMetadata for template-device allocations
        # (allocator.go:84-86 ResourceClaimAllocationMetadata accessor)
        self.claim_allocation_metadata: dict[str, ClaimAllocationMetadata] = {}
        # instance types seen via template_devices, for superposition retries
        self._template_it_by_name: dict[str, object] = {}

    def superpose_template_allocation(self, node_claim_id: str, per_it: dict) -> tuple[dict, dict]:
        """Per-instance-type requirement superposition (allocator.go:90-134).

        `per_it` maps instance type name -> (tracker, AllocationResult) for
        ONE NodeClaim's template-device allocations, in evaluation order.
        Each IT's device choice CONTRIBUTES the requirements its devices pin;
        a claim's topology is pessimistically the INTERSECTION of contributed
        requirements across the ITs the NodeClaim stays superposed over. An
        IT whose contribution would collapse any claim's intersection to the
        empty set is PRUNED (the NodeClaim model cannot express "type A in
        zone A OR type B in zone B").

        Returns (surviving per_it entries, metadata by claim key). Commit the
        metadata via commit_template_metadata once the NodeClaim is kept."""
        from ...scheduling.requirements import Requirements

        metas: dict[str, ClaimAllocationMetadata] = {}
        running: dict[str, Requirements] = {}  # claim key -> intersection so far
        kept: dict = {}

        def trial_of(entry):
            """Trial contributions by claim key against the running totals
            (None when any claim's intersection would collapse) — O(claims)
            per instance type, not O(kept ITs x claims)."""
            _tracker, result = entry
            trial: dict[str, Requirements] = {}
            for claim_key, picks in result.picks.items():
                reqs = requirements_from_picks(picks)
                total = running.get(claim_key)
                total = total.copy() if total is not None else Requirements()
                total.add(*reqs.values())
                if not _requirements_satisfiable(total):
                    return None
                trial[claim_key] = reqs
            return trial

        for it_name, entry in per_it.items():
            trial = trial_of(entry)
            if trial is None and entry[1].picks:
                # the first DFS ran without the cross-type intersections;
                # retry with them seeded as per-claim bounds so the
                # requirements-aware search finds an alternative same-type
                # device combination wherever one exists
                entry = self._reallocate_compatible(node_claim_id, it_name, entry, running)
                trial = trial_of(entry) if entry is not None else None
            if trial is None or entry is None:
                continue
            kept[it_name] = entry
            _tracker, result = entry
            for claim_key, reqs in trial.items():
                meta = metas.setdefault(
                    claim_key, ClaimAllocationMetadata(node_claim_id=node_claim_id, used_template_devices=True)
                )
                meta.contributed[it_name] = reqs
                meta.devices[it_name] = result.picks[claim_key]
                total = running.setdefault(claim_key, Requirements())
                total.add(*reqs.values())
        for meta in metas.values():
            meta.recompute_total()
        return kept, metas

    def _reallocate_compatible(self, node_claim_id: str, it_name: str, entry, running: dict):
        """Retry one instance type's template allocation under the running
        cross-instance-type intersections, against the SAME baseline tracker
        (which carries earlier pods' consumption on this in-flight NodeClaim).
        The running totals seed the requirements-aware DFS as per-claim
        bounds, so the search explores around BOTH cross-type conflicts and
        mutually-conflicting same-type device combinations — an alternative
        combination keeps the type alive wherever one exists. Returns a
        (tracker, result) entry or None."""
        old_tracker, old_result = entry
        claims = list(old_result.claims)
        if not claims:
            return None
        it = self._template_it_by_name.get(it_name)
        if it is None:
            return None
        # allocate() is pure w.r.t. the tracker, so reusing the entry's
        # baseline preserves earlier pods' device/counter consumption on this
        # NodeClaim (commit later applies the new picks against it)
        result, err = self.allocate(node_claim_id, self.template_devices(it), claims, old_tracker, req_bounds=running)
        return (old_tracker, result) if err is None else None

    def commit_template_metadata(self, metas: dict) -> None:
        self.claim_allocation_metadata.update(metas)

    def resource_claim_allocation_metadata(self) -> dict:
        """Copy of the allocator's per-claim template-allocation metadata
        (allocator.go ResourceClaimAllocationMetadata)."""
        return dict(self.claim_allocation_metadata)

    def release_instance_types(self, claim_key: str, removed_it_names) -> None:
        """The NodeClaim released instance types (price filtering, finalize):
        drop their contributions and relax the pessimistic intersection
        (allocator.go totalRequirements 'updated each time instance types are
        released')."""
        meta = self.claim_allocation_metadata.get(claim_key)
        if meta is None:
            return
        for name in removed_it_names:
            meta.contributed.pop(name, None)
            meta.devices.pop(name, None)
        meta.recompute_total()

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else time.monotonic()

    # -- allocation ----------------------------------------------------------
    def allocate(self, target_id: str, devices: list[_DeviceRef], claims: list, tracker: AllocationTracker, req_bounds: dict | None = None):
        """Try to satisfy every unallocated claim from `devices` given the
        tracker state. Returns (AllocationResult, None) or (None, err). Pure:
        the tracker is copied, not mutated; commit applies the picks.

        The DFS is REQUIREMENTS-AWARE (allocator_test.go "Topology requirement
        narrowing"): every picked device's node requirements accumulate into
        the search state, a device whose requirements would collapse the
        intersection is skipped, and backtracking restores the accumulation —
        so mutually-conflicting device combinations are explored around, not
        failed on. `req_bounds` (claim key -> Requirements) seeds a claim's
        accumulation with externally-pinned topology (the superposition retry
        passes the cross-instance-type running intersections).

        The search tree spans ALL claims (the reference's decision tree
        covers every claim's requests together): all picks land on one node,
        so requirements tighten across claims, and a later claim's failure
        backtracks into earlier claims' device choices (allocator_test.go
        "should tighten baseline requirements for subsequent unallocated
        claims", "Multi-claim competition")."""
        from ...scheduling.requirements import Requirements

        result = AllocationResult(claims=list(claims))
        work = tracker.copy()
        deadline = self._now() + ALLOCATE_TIMEOUT_SECONDS
        jobs = []  # (rc, externally-pinned extra bound | None)
        for rc in claims:
            if rc.status.allocation:
                # allocated in-cluster: pod must land where the claim lives
                node = rc.status.allocation.get("nodeName", "")
                if node and node != target_id:
                    return None, f"resourceclaim {rc.key()} is allocated on {node}"
                continue
            prior = self.claim_targets.get(rc.key())
            if prior is not None:
                if prior != target_id:
                    return None, f"resourceclaim {rc.key()} is held by {prior}"
                continue  # already allocated this loop on this very target
            extra = req_bounds.get(rc.key()) if req_bounds is not None else None
            jobs.append((rc, extra))

        shared_reqs = [Requirements()]  # node-level accumulation, all claims
        picks_by_claim: dict[str, list] = {}
        failed: list = [None]  # deepest claim that could not be satisfied
        # the devices list is fixed for the whole call; parse each device's
        # requirements ONCE instead of on every DFS visit/backtrack
        dev_reqs = {id(ref.device): _device_requirements(ref.device) for ref in devices}

        def run(j: int) -> bool:
            if j == len(jobs):
                return True
            rc, extra = jobs[j]
            ok = self._allocate_claim(
                rc, devices, work, deadline, shared_reqs, extra, picks_by_claim, lambda: run(j + 1), dev_reqs
            )
            if not ok and failed[0] is None:
                failed[0] = rc
            return ok

        if not run(0):
            rc = failed[0]
            return None, f"cannot allocate devices for resourceclaim {rc.key() if rc else '?'}"
        for rc, _extra in jobs:
            result.picks[rc.key()] = picks_by_claim.get(rc.key(), [])
        return result, None

    def commit(self, target_id: str, result: AllocationResult, tracker: AllocationTracker) -> None:
        """Apply a successful allocation to the given tracker and pin the
        claims to the target (allocation.Commit, allocator.go:193-220)."""
        for claim_key, picks in result.picks.items():
            for _, ref, cap in picks:
                tracker.take(ref, cap)
            self.claim_targets[claim_key] = target_id

    def _allocate_claim(self, rc, devices: list[_DeviceRef], tracker: AllocationTracker, deadline: float, cur_reqs: list, extra_bound, picks_by_claim: dict, cont, dev_reqs: dict | None = None):
        """DFS over (request x candidate device) choices (allocator.go DFS).
        `cur_reqs` is the single-cell node-level requirements accumulation
        SHARED across all claims of one allocate() call: devices whose own
        requirements would collapse it (or this claim's `extra_bound`) are
        skipped, successful picks tighten it, and backtracking restores it.
        `cont` runs the rest of the claim chain once this claim is fully
        assigned; its False return backtracks into THIS claim's choices."""

        constraints = [
            _MatchAttributeConstraint(c["matchAttribute"], c.get("requests"))
            for c in rc.constraints
            if c.get("matchAttribute")
        ]
        requests = rc.requests
        picks: list = []
        picks_by_claim[rc.key()] = picks  # live; final contents on success

        def bound_ok(reqs) -> bool:
            if not _requirements_satisfiable(reqs):
                return False
            if extra_bound is not None:
                trial = reqs.copy()
                trial.add(*extra_bound.values())
                if not _requirements_satisfiable(trial):
                    return False
            return True

        # fail fast on a collapsed seed: the shared node requirements already
        # contradict this claim's externally-pinned topology — backtrack into
        # earlier claims' choices rather than "succeeding" on an impossible
        # node (review finding: requirement-free devices would otherwise
        # carry the collapsed bound through unchecked)
        if not bound_ok(cur_reqs[0]):
            picks_by_claim.pop(rc.key(), None)
            return False

        def try_tighten(ref):
            """The accumulated requirements with `ref`'s added, or None when
            the intersection collapses (device topologically incompatible
            with the path or with this claim's external bound)."""
            if dev_reqs is not None:
                dreqs = dev_reqs.get(id(ref.device))
                if dreqs is None:
                    dreqs = dev_reqs[id(ref.device)] = _device_requirements(ref.device)
            else:
                dreqs = _device_requirements(ref.device)
            if not dreqs:
                return cur_reqs[0]  # unconstrained device: state unchanged
            trial = cur_reqs[0].copy()
            trial.add(*dreqs)
            if not bound_ok(trial):
                return None
            return trial

        def eligible(req, ref):
            sels = list(req.get("selectors") or [])
            cls = req.get("deviceClassName")
            if cls is not None:
                if cls not in self.class_selectors:
                    return False
                sels = list(self.class_selectors[cls]) + sels
            return device_matches_selectors(ref.device, sels, driver=ref.driver)

        def dfs(req_idx: int) -> bool:
            if self._now() > deadline:
                return False
            if req_idx == len(requests):
                # claim fully assigned: run the rest of the claim chain; a
                # False return resumes THIS claim's search (cross-claim
                # backtracking)
                return cont()
            req = requests[req_idx]
            name = req.get("name", f"request-{req_idx}")
            want_cap = {k: (v if isinstance(v, Quantity) else Quantity.parse(v)) for k, v in (req.get("capacity") or {}).items()}
            mode = req.get("allocationMode", "ExactCount")
            count = int(req.get("count", 1))
            candidates = [r for r in devices if eligible(req, r)]
            if mode == "All":
                # take every candidate or none: unwind exactly what was taken
                # (including per-constraint add/remove pairing and the
                # requirements accumulation) on any failure. Zero matching
                # candidates fails the request (allocator_test.go: "should
                # fail when an All-mode request matches zero devices")
                if not candidates:
                    return False
                saved_reqs = cur_reqs[0]
                chosen: list = []  # (ref, [constraints whose add() succeeded])
                ok = True
                for ref in candidates:
                    if not tracker.available(ref, want_cap):
                        ok = False
                        break
                    tightened = try_tighten(ref)
                    if tightened is None:
                        ok = False
                        break
                    added = []
                    for c in constraints:
                        if c.add(name, ref.device):
                            added.append(c)
                        else:
                            ok = False
                            break
                    if not ok:
                        for c in added:
                            c.remove(name)
                        break
                    cur_reqs[0] = tightened
                    tracker.take(ref, want_cap)
                    chosen.append((ref, added))
                    picks.append((name, ref, want_cap or None))
                if ok and dfs(req_idx + 1):
                    return True
                for ref, added in reversed(chosen):
                    tracker.release(ref, want_cap)
                    for c in added:
                        c.remove(name)
                    picks.pop()
                cur_reqs[0] = saved_reqs
                return False

            def choose(k: int, start: int) -> bool:
                if k == 0:
                    return dfs(req_idx + 1)
                if self._now() > deadline:
                    return False
                for i in range(start, len(candidates)):
                    ref = candidates[i]
                    taken = (name, ref, want_cap or None)
                    if taken in picks or not tracker.available(ref, want_cap):
                        continue
                    tightened = try_tighten(ref)
                    if tightened is None:
                        continue  # topologically incompatible with the path
                    ok = True
                    added = []
                    for c in constraints:
                        if c.add(name, ref.device):
                            added.append(c)
                        else:
                            ok = False
                            break
                    if not ok:
                        for c in added:
                            c.remove(name)
                        continue
                    saved = cur_reqs[0]
                    cur_reqs[0] = tightened
                    tracker.take(ref, want_cap)
                    picks.append(taken)
                    if choose(k - 1, i + 1):
                        return True
                    picks.pop()
                    tracker.release(ref, want_cap)
                    cur_reqs[0] = saved
                    for c in added:
                        c.remove(name)
                return False

            return choose(count, 0)

        ok = dfs(0)
        if not ok:
            picks_by_claim.pop(rc.key(), None)
        return ok

    # -- candidate views ------------------------------------------------------
    def allocate_for_node(self, node_name: str, claims: list):
        """Existing node: allocate from its published slices
        (existingnode.go:125-134 draExistingNode)."""
        devices = self.node_devices.get(node_name, [])
        return self.allocate(node_name, devices, claims, self.loop_tracker)

    def commit_for_node(self, node_name: str, result: AllocationResult) -> None:
        self.commit(node_name, result, self.loop_tracker)

    def template_devices(self, instance_type) -> list[_DeviceRef]:
        """Devices an instance type would ship when launched (cloudprovider
        types.go:133-135 DynamicResources). Registers the template pool's
        shared-counter budget; each candidate's tracker lazily materializes
        its OWN remaining copy, so every launched node gets a fresh budget
        (partitionable_devices.go template counters)."""
        self._template_it_by_name[instance_type.name] = instance_type
        out = []
        for d in getattr(instance_type, "dynamic_resources", None) or []:
            out.append(
                # device_id keeps the "template" scope sentinel; the ref's
                # driver prefers the device's declared DRA driver so CEL
                # `device.driver` selectors work pre-launch
                _DeviceRef(device=d, driver=d.driver or "template", pool=instance_type.name,
                           device_id=("template", instance_type.name, "pool", d.name))
            )
        sets = getattr(instance_type, "dynamic_resources_counters", None)
        if sets:
            self.counter_budgets.setdefault(("template", instance_type.name, "pool"), _budget_from_sets(sets))
        return out
