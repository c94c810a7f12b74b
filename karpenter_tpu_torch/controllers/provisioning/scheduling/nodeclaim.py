"""In-flight scheduling NodeClaim: template, CanAdd, instance-type filtering.

Reference: scheduling/nodeclaim.go (CanAdd :124-208, filterInstanceTypes
:541-640, FinalizeScheduling :383-409) and nodeclaimtemplate.go (requirement
assembly, MaxInstanceTypes truncation, capacity-type narrowing).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from ....apis import labels as wk
from ....apis.nodeclaim import NodeClaim as APINodeClaim
from ....apis.nodeclaim import NodeClaimSpec, NodeClassReference
from ....cloudprovider.types import InstanceType, order_by_price
from ....kube.objects import ObjectMeta
from ....scheduling.hostports import HostPortUsage, pod_host_ports
from ....scheduling.requirements import Operator, Requirement, Requirements
from ....scheduling.taints import taints_tolerate_pod
from ....utils import resources as res
from ....utils.durations import parse_duration
from ....utils.quantity import Quantity

MAX_INSTANCE_TYPES = 600

_hostname_seq = itertools.count(1)

# native requirements-intersection tables, one per NodeClaimTemplate per solve
# (weak-keyed so solves don't leak tables; a table that fails to build raises
# native.NativeBuildError; KARPENTER_DISABLE_NATIVE keeps every template on
# the Python algebra — karpenter_tpu_torch/native)
import weakref

_native_tables: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


# Below this many instance types the Python set algebra's short-circuiting
# beats the per-call ctypes query lowering (measured ~0.8x at 36 rows, ~1.0x
# at 500 simple rows, 15x isolated on requirement-heavy tables)
NATIVE_MIN_TABLE_ROWS = 200


def _native_table_for(template):
    from ....native import ReqTable, UnsupportedRequirements, disabled

    its = template.instance_type_options
    if len(its) < NATIVE_MIN_TABLE_ROWS or disabled():
        return None
    cached = _native_tables.get(template)
    if cached is None:
        try:
            cached = (ReqTable([it.requirements for it in its]), {id(it): i for i, it in enumerate(its)})
        except UnsupportedRequirements:
            cached = (None, None)  # e.g. >int64 integer values; stay on Python
        _native_tables[template] = cached
    return cached if cached[0] is not None else None


@dataclass
class DaemonOverheadGroup:
    """Instance types sharing a daemon-compatibility class and hence the same
    daemon overhead (scheduler.go:963-1004)."""

    instance_types: list[InstanceType]
    daemon_overhead: dict[str, Quantity]
    host_port_usage: HostPortUsage = field(default_factory=HostPortUsage)

    def copy(self) -> "DaemonOverheadGroup":
        return DaemonOverheadGroup(self.instance_types, self.daemon_overhead, self.host_port_usage.copy())


class NodeClaimTemplate:
    """Scheduling view of a NodePool's NodeClaim template
    (nodeclaimtemplate.go:55-95)."""

    def __init__(self, node_pool):
        self.node_pool = node_pool
        self.nodepool_name = node_pool.metadata.name
        self.weight = node_pool.spec.weight
        self.is_static = node_pool.is_static()
        self.labels = dict(node_pool.spec.template.labels)
        self.labels[wk.NODEPOOL_LABEL_KEY] = node_pool.metadata.name
        self.annotations = dict(node_pool.spec.template.annotations)
        self.annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = node_pool.hash()
        # both hash AND hash-version propagate to claims (nodeclaimtemplate.go);
        # static drift only compares hashes under matching versions
        from ...nodepool.hash import NODEPOOL_HASH_VERSION

        self.annotations[wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = NODEPOOL_HASH_VERSION
        self.taints = list(node_pool.spec.template.taints)
        self.startup_taints = list(node_pool.spec.template.startup_taints)
        self.instance_type_options: list[InstanceType] = []
        self.requirements = Requirements()
        self.requirements.add(*Requirements.from_node_selector_terms(node_pool.spec.template.requirements).values())
        self.requirements.add(*Requirements.from_labels(self.labels).values())
        # simulation-only keys so DaemonSets with affinity on them count
        self.requirements.add(Requirement(wk.NODE_REGISTERED_LABEL_KEY, "In", ["true"]))
        self.requirements.add(Requirement(wk.NODE_INITIALIZED_LABEL_KEY, "In", ["true"]))


class SchedulingNodeClaim:
    """A NodeClaim being built up during a single Solve
    (scheduling/nodeclaim.go:52-120)."""

    def __init__(
        self,
        template: NodeClaimTemplate,
        topology,
        daemon_overhead_groups: list[DaemonOverheadGroup],
        instance_types: list[InstanceType],
        allocator=None,
        reservation_manager=None,
        reserved_offering_mode: str = "fallback",  # fallback | strict (scheduler.go:59-77)
        filter_cache: Optional[dict] = None,  # solve-scoped filter_instance_types memo
    ):
        self.template = template
        self.topology = topology
        self.filter_cache = filter_cache
        self.daemon_overhead_groups = [g.copy() for g in daemon_overhead_groups]
        self.pods: list = []
        self.instance_type_options = instance_types
        self.allocator = allocator  # DRA; None when the gate is off
        self.dra_trackers: dict = {}  # instance type name -> AllocationTracker
        self._pending_dra = None  # {it name: AllocationResult} awaiting add()
        self._pending_dra_meta = None  # {claim key: ClaimAllocationMetadata}
        self._dra_claim_keys: set = set()  # claims committed on this node
        # reserved-offering accounting (nodeclaim.go:43-62): the claim tracks
        # the reserved offerings it currently holds so stale ones release on
        # later narrowing and compatible ones can re-expand across iterations
        self.reservation_manager = reservation_manager
        self.reserved_offering_mode = reserved_offering_mode
        self.reserved_offerings: list = []
        self._pending_reserved: list = []
        self.requirements = Requirements()
        self.requirements.add(*template.requirements.values())
        self.hostname = f"hostname-placeholder-{next(_hostname_seq):05d}"
        self.requirements.add(Requirement(wk.HOSTNAME_LABEL_KEY, "In", [self.hostname]))
        topology.register(wk.HOSTNAME_LABEL_KEY, self.hostname)
        self.spec_requests: dict[str, Quantity] = {}  # accumulated pod requests
        # monotone state version: bumped on every add(); the scheduler's fit
        # memo stamps static-pass entries with it so a stale pass is recomputed
        # after this claim's options narrow or its requirements tighten
        self._version = 0

    def rehydrate(self, topology, allocator=None, reservation_manager=None, reserved_offering_mode: str = "fallback", filter_cache: Optional[dict] = None) -> None:
        """Re-wire the solve-scoped plumbing `__init__` normally provides, for
        claims built OUTSIDE a Scheduler: the tensor decode constructs claims
        with `__new__` (the device result fully determines them), and the
        decode's minValues repair then adopts them as live in-flight claims.
        The field list lives here, next to `__init__`, so new per-solve state
        cannot be missed on the adoption path (solver/ffd.py _adopt_claim)."""
        self.topology = topology
        self.filter_cache = filter_cache
        # decode shares one group list per template across claims (and across
        # solves via its cache); Add() mutates group port usage, so a live
        # claim needs its own copies — exactly like __init__
        self.daemon_overhead_groups = [g.copy() for g in self.daemon_overhead_groups]
        self.allocator = allocator
        self.dra_trackers = {}
        self._pending_dra = None
        self._pending_dra_meta = None
        self._dra_claim_keys = set()
        self.reservation_manager = reservation_manager
        self.reserved_offering_mode = reserved_offering_mode
        self.reserved_offerings = getattr(self, "reserved_offerings", [])
        self._pending_reserved = []
        self._version = 0

    @property
    def nodepool_name(self) -> str:
        return self.template.nodepool_name

    def can_add(self, pod, pod_data, relax_min_values: bool = False):
        """Returns (updated_requirements, remaining_instance_types) or an error
        string (nodeclaim.go:124-158)."""
        base, err = self.can_add_static(pod, pod_data)
        if err is not None:
            return None, None, err
        reqs, its, err, _permanent = self.can_add_dynamic(pod, pod_data, base, relax_min_values)
        return reqs, its, err

    def can_add_static(self, pod, pod_data):
        """The MONOTONE prefix of can_add: template taints (fixed for the
        whole solve) and requirements compatibility (this claim's requirements
        only ever tighten — add() intersects). A rejection here can never turn
        into an acceptance later, so the scheduler's fit memo caches it
        permanently per pod signature. Returns (base_requirements, None) or
        (None, err)."""
        err = self.static_error(pod, pod_data)
        if err is not None:
            return None, err
        return self.static_base(pod_data), None

    def static_error(self, pod, pod_data) -> str | None:
        """can_add_static's verdict without its copy of the requirements."""
        err = taints_tolerate_pod(self.template.taints, pod, include_prefer_no_schedule=True)
        if err is not None:
            return err
        cerr = self.requirements.compatible(pod_data.requirements, allow_undefined=wk.WELL_KNOWN_LABELS)
        if cerr is not None:
            return f"incompatible requirements, {cerr}"
        return None

    def static_base(self, pod_data) -> Requirements:
        """can_add_static's base once static_error passed: this claim's
        requirements and the pod's, in a fresh Requirements."""
        base = Requirements()
        base.add(*self.requirements.values())
        base.add(*pod_data.requirements.values())
        return base

    def can_add_dynamic(self, pod, pod_data, base: Requirements, relax_min_values: bool = False):
        """The suffix of can_add: volume alternatives, topology, instance-type
        filtering, DRA, reservations. Returns (reqs, its, err, permanent) —
        `permanent` is True when the rejection is monotone in this claim's
        state REGARDLESS of topology/reservation churn: every instance type
        still in the option set lacks the raw resources for the accumulated
        requests plus this pod (options only narrow, requests only grow), so
        the scheduler's fit memo may cache the rejection for the signature.

        Try each volume topology alternative; the selected constraints affect
        downstream topology and instance-type checks (nodeclaim.go:138-157)."""
        last_err = None
        all_permanent = True  # a rejection is permanent only if EVERY alternative's is
        self._pending_dra = None
        self._pending_dra_meta = None
        self._pending_reserved = []
        for vol_reqs in pod_data.volume_requirements or [None]:
            reqs, its, err, permanent = self._try_volume_alternative(pod, pod_data, base, vol_reqs, relax_min_values)
            if err is not None:
                last_err = err
                all_permanent = all_permanent and permanent
                continue
            return reqs, its, None, False
        return None, None, last_err, all_permanent

    def _try_volume_alternative(self, pod, pod_data, base: Requirements, vol_reqs, relax_min_values: bool):
        """One alternative: volume reqs -> topology -> instance-type filter
        (nodeclaim.go:164-240). Volume reqs narrow the claim only, never the
        pod's affinity, preserving TSC counting semantics. Returns
        (reqs, its, err, permanent) — see can_add_dynamic."""
        claim_reqs = Requirements()
        claim_reqs.add(*base.values())
        if vol_reqs is not None:
            cerr = claim_reqs.compatible(vol_reqs, allow_undefined=wk.WELL_KNOWN_LABELS)
            if cerr is not None:
                return None, None, f"incompatible volume requirements, {cerr}", False
            claim_reqs.add(*vol_reqs.values())

        topo = self.topology.add_requirements(
            pod, self.template.taints, pod_data.strict_requirements, claim_reqs, allow_undefined=wk.WELL_KNOWN_LABELS
        )
        if isinstance(topo, str):
            return None, None, topo, False
        cerr = claim_reqs.compatible(topo, allow_undefined=wk.WELL_KNOWN_LABELS)
        if cerr is not None:
            return None, None, cerr, False
        claim_reqs.add(*topo.values())

        requests = res.merge(self.spec_requests, pod_data.requests)
        remaining, unsatisfiable, ferr, capacity_exhausted = filter_instance_types_cached(
            getattr(self, "filter_cache", None),
            self.instance_type_options, claim_reqs, pod, pod_data.requests, self.daemon_overhead_groups, requests, relax_min_values,
            native=_native_table_for(self.template),
        )
        if relax_min_values:
            for key, mv in unsatisfiable.items():
                # copy-on-write: claim_reqs aliases Requirement objects owned by
                # the template; mutating in place would relax minValues for every
                # subsequent claim in the solve
                relaxed = claim_reqs.get(key).copy()
                relaxed.min_values = mv
                claim_reqs.replace(relaxed)
        if ferr is not None:
            return None, None, ferr, capacity_exhausted

        # DRA: keep only instance types whose template devices satisfy the
        # pod's claims; the reference allocates before the filter and prunes
        # unsupported types after (nodeclaim.go:177-194,225-229). Per-IT
        # device choices then SUPERPOSE their contributed requirements: a
        # claim's topology is the intersection across surviving types, and
        # types that would collapse it to empty are pruned
        # (allocator.go:90-134)
        if (pod_data.resource_claims or pod_data.resource_claim_err) and self.allocator is not None:
            if pod_data.resource_claim_err is not None:
                return None, None, pod_data.resource_claim_err, False
            per_it = {}
            for it in remaining:
                tracker = self.dra_trackers.get(it.name)
                if tracker is None:
                    from ....scheduling.dynamicresources.allocator import AllocationTracker

                    # shares the allocator's pool-budget registry so template
                    # counter sets (partitionable devices) bound this claim
                    tracker = AllocationTracker(budgets=self.allocator.counter_budgets)
                result, derr = self.allocator.allocate(
                    self.hostname, self.allocator.template_devices(it), pod_data.resource_claims, tracker
                )
                if derr is None:
                    per_it[it.name] = (tracker, result)
            kept, metas = self.allocator.superpose_template_allocation(self.hostname, per_it)
            surviving = [it for it in remaining if it.name in kept]
            if not surviving:
                return None, None, "no instance type can allocate the pod's dynamic resources", False
            remaining = surviving
            self._pending_dra = kept
            self._pending_dra_meta = metas

        # reserved-offering reservations (nodeclaim.go:303-350): collect every
        # compatible+available reserved offering the claim could launch into;
        # under strict mode, fail rather than silently lose reserved capacity
        ofs, rerr = self._offerings_to_reserve(remaining, claim_reqs)
        if rerr is not None:
            # reservation state is NOT monotone (releases can re-open options)
            return None, None, rerr, False
        self._pending_reserved = ofs
        return claim_reqs, remaining, None, False

    def _offerings_to_reserve(self, instance_types: list[InstanceType], claim_reqs: Requirements):
        """Returns (reservable offerings, err). Reservation is pessimistic:
        any reserved offering the claim is compatible with is claimed, so two
        claims in one solve can never oversubscribe a reservation."""
        if self.reservation_manager is None:
            return [], None
        has_compatible = False
        reservable = []
        for it in instance_types:
            for o in it.offerings:
                if not o.available or o.capacity_type() != wk.CAPACITY_TYPE_RESERVED:
                    continue
                if claim_reqs.compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) is not None:
                    continue
                has_compatible = True
                if self.reservation_manager.can_reserve(self.hostname, o):
                    reservable.append(o)
        if self.reserved_offering_mode == "strict":
            if has_compatible and not reservable:
                return None, "reserved offering error: compatible reserved offerings exist but could not be reserved"
            if self.reserved_offerings and not reservable:
                return None, "reserved offering error: updated constraints would remove all reserved offering options"
        return reservable, None

    def add(self, pod, pod_data, updated_requirements: Requirements, updated_instance_types: list[InstanceType]) -> None:
        # getattr: decode builds claims with __new__ (rehydrate() re-seeds the
        # version, but direct adds on bare claims must not require it)
        self._version = getattr(self, "_version", 0) + 1
        self.pods.append(pod)
        self.requirements = updated_requirements
        removed = set()
        if self.allocator is not None and (self._dra_claim_keys or self._pending_dra_meta):
            removed = {it.name for it in self.instance_type_options} - {it.name for it in updated_instance_types}
        self.instance_type_options = updated_instance_types
        self.spec_requests = res.merge(self.spec_requests, pod_data.requests)
        if self.reservation_manager is not None:
            # reserve the surviving set, release what narrowing dropped
            # (nodeclaim.go:260-262 + releaseReservedOfferings :280-295)
            self.reservation_manager.reserve(self.hostname, *self._pending_reserved)
            updated_ids = {o.reservation_id() for o in self._pending_reserved}
            stale = [o for o in self.reserved_offerings if o.reservation_id() not in updated_ids]
            self.reservation_manager.release(self.hostname, *stale)
            self.reserved_offerings = self._pending_reserved
            self._pending_reserved = []
        if self._pending_dra is not None and self.allocator is not None:
            # commit per-instance-type device picks so later pods on this
            # in-flight node see the consumed template budget
            for it_name, (tracker, result) in self._pending_dra.items():
                self.dra_trackers[it_name] = tracker
                self.allocator.commit(self.hostname, result, tracker)
            if self._pending_dra_meta:
                self.allocator.commit_template_metadata(self._pending_dra_meta)
                self._dra_claim_keys.update(self._pending_dra_meta)
            self._pending_dra = None
            self._pending_dra_meta = None
        # single release site: instance types dropped by this pod's narrowing
        # (the pre-add option set is a superset of every claim's superposition
        # filter set, so `removed` covers prior AND just-committed claims)
        # relax committed claims' pessimistic contributions (allocator.go
        # "totalRequirements are updated each time instance types are released")
        if self.allocator is not None and self._dra_claim_keys and removed:
            for ck in self._dra_claim_keys:
                self.allocator.release_instance_types(ck, removed)
        # track host ports per daemon group so future pods see conflicts
        ports = pod_host_ports(pod)
        for g in self.daemon_overhead_groups:
            g.host_port_usage.add(pod.key(), ports)
        self.topology.record(pod, self.template.taints, self.requirements)

    def finalize(self) -> None:
        """Drop the hostname placeholder so the claim can land anywhere; pin
        reserved claims to their reservation ids (nodeclaim.go:383-409)."""
        reqs = Requirements()
        for key, r in self.requirements.items():
            if key != wk.HOSTNAME_LABEL_KEY:
                reqs.replace(r)
        if self.reserved_offerings:
            # tightening to reserved gives automatic drift handling when the
            # capacity-type label is later updated by the cloud provider, and
            # the id set prevents overlaunching into a single reservation
            reqs.replace(Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [wk.CAPACITY_TYPE_RESERVED]))
            rids = sorted({o.reservation_id() for o in self.reserved_offerings})
            reqs.replace(Requirement(wk.RESERVATION_ID_LABEL_KEY, "In", rids))
        self.requirements = reqs

    def to_api_node_claim(self, clock=None) -> APINodeClaim:
        """Produce the API NodeClaim to create (nodeclaimtemplate.go ToNodeClaim):
        price-ordered truncated instance types and narrowed capacity types."""
        its = order_by_price(self.instance_type_options, self.requirements)[:MAX_INSTANCE_TYPES]
        reqs = Requirements()
        for key, r in self.requirements.items():
            if key not in (wk.NODE_REGISTERED_LABEL_KEY, wk.NODE_INITIALIZED_LABEL_KEY):
                reqs.replace(r.copy())
        mv = self.requirements.get(wk.INSTANCE_TYPE_LABEL_KEY).min_values
        reqs.replace(Requirement(wk.INSTANCE_TYPE_LABEL_KEY, "In", [it.name for it in its], min_values=mv))
        cts = sorted(
            {
                o.capacity_type()
                for it in its
                for o in it.offerings
                if o.available and reqs.intersects(o.requirements) is None
            }
        )
        if cts:
            reqs.add(Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", cts))

        tmpl = self.template
        # include daemon overhead in the claim's resource requests (reference
        # FinalizeScheduling -> addDaemonRequests): take the overhead of the
        # group backing the cheapest surviving instance type
        spec_requests = dict(self.spec_requests)
        surviving = {id(x) for x in its}
        for g in self.daemon_overhead_groups:
            if any(id(x) in surviving for x in g.instance_types):
                spec_requests = res.merge(spec_requests, g.daemon_overhead)
                break
        req_dicts = [d for r in reqs.values() for d in _req_to_dicts(r)]
        # keep the instance-type values price-ordered (cheapest first) so
        # downstream pickers and truncation see the intended preference
        for d in req_dicts:
            if d["key"] == wk.INSTANCE_TYPE_LABEL_KEY and d["operator"] == "In":
                d["values"] = [it.name for it in its]
        nc = APINodeClaim(
            metadata=ObjectMeta(
                name=f"{tmpl.nodepool_name}-{_rand_suffix()}",
                labels={**tmpl.labels, **_concrete_labels(reqs)},
                annotations=dict(tmpl.annotations),
                finalizers=[wk.TERMINATION_FINALIZER],
            ),
            spec=NodeClaimSpec(
                taints=list(tmpl.taints),
                startup_taints=list(tmpl.startup_taints),
                requirements=req_dicts,
                resources=spec_requests,
                node_class_ref=NodeClassReference(**tmpl.node_pool.spec.template.node_class_ref)
                if isinstance(tmpl.node_pool.spec.template.node_class_ref, dict)
                else tmpl.node_pool.spec.template.node_class_ref,
                termination_grace_period=parse_duration(tmpl.node_pool.spec.template.termination_grace_period),
                expire_after=parse_duration(tmpl.node_pool.spec.template.expire_after),
            ),
        )
        return nc


def _concrete_labels(reqs: Requirements) -> dict[str, str]:
    out = {}
    for key, r in reqs.items():
        if key in (wk.NODE_REGISTERED_LABEL_KEY, wk.NODE_INITIALIZED_LABEL_KEY, wk.HOSTNAME_LABEL_KEY):
            continue
        if r.operator() == Operator.IN and len(r.values) == 1:
            out[key] = r.any()
    return out


def _req_to_dicts(r: Requirement) -> list[dict]:
    """Serialize back to NodeSelectorRequirement dicts; a requirement carrying
    both bounds emits two entries (requirement.go:116-126)."""
    out: list[dict] = []
    if r.gte is not None:
        out.append({"key": r.key, "operator": "Gte", "values": [str(r.gte)]})
    if r.lte is not None:
        out.append({"key": r.key, "operator": "Lte", "values": [str(r.lte)]})
    if not out:
        out.append({"key": r.key, "operator": r.operator().value, "values": r.values_list()})
    if r.min_values is not None:
        for d in out:
            d["minValues"] = r.min_values
    return out


def _rand_suffix() -> str:
    # 10 hex chars: a 5-char suffix has ~9% birthday-collision odds by 400
    # generated names, which intermittently failed large solves with
    # AlreadyExists on claim create (kube generateName uses 5 chars but the
    # apiserver retries; the store does not)
    import random

    return f"{random.randrange(16**10):010x}"


def _reqs_content_key(reqs: Requirements) -> tuple:
    """Content identity of a Requirements set — equal keys for equal
    filtering behavior. The per-claim HOSTNAME placeholder is excluded: no
    instance type or offering constrains hostname, so it cannot change the
    filter result, and including it would make every claim's key unique
    (zero hits). Entries are keyed-unique, so sorting by label key alone
    gives a canonical order (frozensets have no total order)."""
    return tuple(
        sorted(
            (
                (r.key, r.complement, frozenset(r.values), r.gte, r.lte, r.min_values)
                for r in reqs.values()
                if r.key != wk.HOSTNAME_LABEL_KEY
            ),
            key=lambda t: t[0],
        )
    )


_FILTER_CACHE_MAX = 50_000


def filter_instance_types_cached(
    cache: Optional[dict],
    instance_types: list[InstanceType],
    requirements: Requirements,
    pod,
    pod_requests: dict[str, Quantity],
    daemon_overhead_groups: list[DaemonOverheadGroup],
    total_requests: dict[str, Quantity],
    relax_min_values: bool = False,
    native=None,
) -> tuple[Optional[list[InstanceType]], dict[str, int], Optional[str], bool]:
    """Solve-scoped memo around `filter_instance_types` (ROADMAP: the
    residual host FFD is ~0.6 ms/pod dominated by this call). The filter is
    a pure function of (type set, requirement CONTENT, accumulated requests,
    daemon groups, relax flag) — identical pod signatures probing the same
    claim state must not re-scan the full 500-type list. Host-port-carrying
    pods bypass the memo: their group conflict check reads mutable
    `host_port_usage` state the key cannot see (portless pods — the dominant
    shape — never conflict)."""
    if cache is None or pod_host_ports(pod):
        return filter_instance_types(
            instance_types, requirements, pod, pod_requests, daemon_overhead_groups,
            total_requests, relax_min_values, native=native,
        )
    its_key = (id(instance_types), len(instance_types))
    reqs_key = _reqs_content_key(requirements)
    groups_key = tuple((id(g.instance_types), id(g.daemon_overhead)) for g in daemon_overhead_groups)
    key = (
        # list identity + length, verified against the stored reference on
        # hit (a solve-scoped cache may see a recycled id after GC): claims
        # REPLACE their option list on every narrowing, so identity tracks
        # content exactly
        its_key,
        reqs_key,
        tuple(sorted((k, q.milli) for k, q in total_requests.items())),
        # group copies share their instance_types/daemon_overhead objects
        # with the template's originals, so claims of one template hit
        groups_key,
        relax_min_values,
    )
    hit = cache.get(key)
    if hit is None or hit[0] is not instance_types:
        if len(cache) >= _FILTER_CACHE_MAX:
            cache.clear()  # bound memory; repopulates within the solve
        # second-level cache: the requirement-dependent verdicts (type
        # compat + per-allocatable-group offering compat) are independent of
        # BOTH the accumulated requests and the narrowing option list, so a
        # landing (new totals, replaced option list) re-runs only the
        # res.fits scan over verdicts cached for the template-wide universe
        skey = ("static", reqs_key, groups_key)
        static = cache.get(skey)
        if static is None:
            static = cache[skey] = _static_group_verdicts(requirements, daemon_overhead_groups, native)
        hit = cache[key] = (
            instance_types,
            *filter_instance_types(
                instance_types, requirements, pod, pod_requests, daemon_overhead_groups,
                total_requests, relax_min_values, native=native, static=static,
            ),
        )
    _its_ref, remaining, unsat, err, capacity_exhausted = hit
    # callers assign/narrow the list downstream — never hand out the cached one
    return (list(remaining) if remaining is not None else None, dict(unsat), err, capacity_exhausted)


def _static_group_verdicts(
    requirements: Requirements,
    daemon_overhead_groups: list[DaemonOverheadGroup],
    native=None,
) -> list[list]:
    """Per daemon-overhead group, the requirement-dependent (hence totals-
    independent) verdicts for every instance type in the TEMPLATE-wide group
    lists: (it, compat, ((allocatable, has_compatible_offering), ...)).
    `filter_instance_types` combines these with the claim's current
    eligibility set and a fresh res.fits scan — the only parts that move when
    a landing grows the accumulated requests and narrows the options. Only
    used on the memoized (portless) path, where no daemon group can be
    skipped by a port conflict."""
    native_mask = native_rows = None
    if native is not None:
        from ....native import UnsupportedRequirements

        table, native_rows = native
        try:
            native_mask = table.filter(requirements)
        except UnsupportedRequirements:
            native_mask = None
    out: list[list] = []
    for group in daemon_overhead_groups:
        rows = []
        for it in group.instance_types:
            if native_mask is not None and id(it) in native_rows:
                compat = native_mask[native_rows[id(it)]] == 1
            else:
                compat = it.requirements.intersects(requirements) is None
            ginfo = tuple(
                (
                    alloc,
                    any(
                        requirements.compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) is None
                        for o in offerings
                    ),
                )
                for alloc, offerings in it.allocatable_offerings_list()
            )
            rows.append((it, compat, ginfo))
        out.append(rows)
    return out


def filter_instance_types(
    instance_types: list[InstanceType],
    requirements: Requirements,
    pod,
    pod_requests: dict[str, Quantity],
    daemon_overhead_groups: list[DaemonOverheadGroup],
    total_requests: dict[str, Quantity],
    relax_min_values: bool = False,
    native=None,
    static=None,
) -> tuple[Optional[list[InstanceType]], dict[str, int], Optional[str], bool]:
    """compat x fits x offering filter per daemon-overhead group
    (nodeclaim.go:541-640). Returns (remaining, unsatisfiable_min_values, err,
    capacity_exhausted). `capacity_exhausted` is True iff the filter rejected
    AND no eligible instance type has an allocatable group with the raw
    resources for `total_requests` — a verdict independent of requirement/
    offering compatibility, hence monotone in claim state (requests only
    grow, the option set only narrows): the scheduler's fit memo may cache
    such a rejection permanently. `native` is an optional (ReqTable, rowmap)
    that answers the per-type intersects check in one C call for the whole
    table."""
    remaining: list[InstanceType] = []
    ports = pod_host_ports(pod)
    any_compat = any_fits = any_offering = any_resource_fit = False

    native_mask = native_rows = None
    if native is not None and static is None:
        from ....native import UnsupportedRequirements

        table, native_rows = native
        try:
            native_mask = table.filter(requirements)
        except UnsupportedRequirements:
            native_mask = None  # query carries >int64 integers; Python path

    any_group_skipped = False
    if static is not None:
        # fast path over precomputed requirement verdicts (only the memoized
        # portless shape reaches here, so no group is ever port-skipped):
        # just apply the current eligibility set and re-run the
        # totals-dependent res.fits scan. The any_* failure flags feed only
        # the rejection message, and a rejection per (signature, claim) state
        # happens once before the fit memo pins it — compute them lazily in a
        # second pass instead of on every landing.
        eligible = {id(it) for it in instance_types}
        fits_fn = res.fits
        for rows, group in zip(static, daemon_overhead_groups):
            total = res.merge(total_requests, group.daemon_overhead) if group.daemon_overhead else total_requests
            for it, compat, ginfo in rows:
                if not compat or id(it) not in eligible:
                    continue
                for alloc, has_compat_off in ginfo:
                    if has_compat_off and fits_fn(total, alloc):
                        remaining.append(it)
                        break
        if not remaining:
            for rows, group in zip(static, daemon_overhead_groups):
                total = res.merge(total_requests, group.daemon_overhead) if group.daemon_overhead else total_requests
                for it, compat, ginfo in rows:
                    if id(it) not in eligible:
                        continue
                    fits = resource_fit = has_offering = False
                    for alloc, has_compat_off in ginfo:
                        has_offering |= has_compat_off
                        if fits_fn(total, alloc):
                            resource_fit = True
                            if has_compat_off:
                                fits = True
                                break
                    any_compat |= compat
                    any_fits |= fits
                    any_offering |= has_offering
                    any_resource_fit |= resource_fit
    else:
        eligible = {id(it) for it in instance_types}
        for group in daemon_overhead_groups:
            if group.host_port_usage.conflicts(pod.key(), ports) is not None:
                any_group_skipped = True  # unevaluated types: capacity verdict incomplete
                continue
            total = res.merge(total_requests, group.daemon_overhead) if group.daemon_overhead else total_requests
            for it in group.instance_types:
                if id(it) not in eligible:
                    continue
                if native_mask is not None and id(it) in native_rows:
                    compat = native_mask[native_rows[id(it)]] == 1
                else:
                    compat = it.requirements.intersects(requirements) is None
                fits, has_offering, resource_fit = _fits_and_offering(it, total, requirements)
                any_compat |= compat
                any_fits |= fits
                any_offering |= has_offering
                any_resource_fit |= resource_fit
                if compat and fits and has_offering:
                    remaining.append(it)

    unsatisfiable: dict[str, int] = {}
    if requirements.has_min_values():
        from ....cloudprovider.types import satisfies_min_values

        _, unsat = satisfies_min_values(remaining, requirements)
        if unsat:
            if not relax_min_values:
                return None, {}, (
                    f"minValues requirement is not met for {sorted(unsat)} "
                    f"(observed {unsat})"
                ), False
            unsatisfiable = unsat

    if not remaining:
        parts = []
        if not any_compat:
            parts.append("no instance type satisfied requirements")
        if not any_fits:
            parts.append(f"no instance type has enough resources for {res.fmt(total_requests)}")
        if not any_offering:
            parts.append("no instance type has a compatible offering")
        if not parts:
            parts.append("no single instance type met requirements/fits/offering simultaneously")
        capacity_exhausted = not any_resource_fit and not any_group_skipped
        return None, unsatisfiable, "; ".join(parts), capacity_exhausted
    return remaining, unsatisfiable, None, False


def _fits_and_offering(it: InstanceType, requests: dict[str, Quantity], requirements: Requirements) -> tuple[bool, bool, bool]:
    """(fits, has_offering, resource_fit) per allocatable-offerings group:
    offerings with capacity/overhead overrides form groups with their OWN
    allocatable, so an instance type fits iff some group both fits the
    requests and holds a compatible offering (nodeclaim.go:624-640 fits +
    types.go:202-257 AllocatableOfferingsList). Deliberately
    reference-exact: fits=False even when resources fit but no group holds a
    compatible offering — the reference's error for that case likewise merges
    both criteria ("no instance type had enough resources or had a required
    offering", nodeclaim.go:505-507). The third element reports the RAW
    resource verdict (some group fits the requests, compatibility aside): a
    requirements-independent — hence monotone — capacity signal the fit memo
    keys permanence on."""
    has_offering = False
    any_resource_fit = False
    for alloc, offerings in it.allocatable_offerings_list():
        resource_fit = res.fits(requests, alloc)
        any_resource_fit |= resource_fit
        for o in offerings:
            if requirements.compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS) is None:
                has_offering = True
                if resource_fit:
                    return True, True, True
                break
    return False, has_offering, any_resource_fit
