"""The scheduling simulation: Solve() bin-packs pending pods onto existing
nodes, in-flight NodeClaims, and new NodeClaims from NodePool templates.

Reference: scheduling/scheduler.go:440-1004 — the FFD loop with preference
relaxation and daemon-overhead groups. This host implementation is the exact
correctness oracle; the TPU tensor solver (karpenter_tpu/solver/tpu.py) is
validated against it and plugs in through the same Solver interface.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field

from ....apis import labels as wk
from ....scheduling.requirements import Operator, Requirement, Requirements
from ....scheduling.taints import pools_taint_prefer_no_schedule, taints_tolerate_pod
from ....utils import resources as res
from ....utils.quantity import Quantity
from ....scheduling.volumeusage import get_volumes
from .existingnode import ExistingNode
from .nodeclaim import DaemonOverheadGroup, NodeClaimTemplate, SchedulingNodeClaim
from .preferences import Preferences
from .queue import Queue
from .topology import Topology
from .volumetopology import VolumeTopology


def _ffd_batch_enabled() -> bool:
    """KARPENTER_FFD_BATCH (default "1"), read at each Scheduler built
    without `ffd_batch`: exactly "0" is the reference's unbatched FFD."""
    return os.environ.get("KARPENTER_FFD_BATCH", "1") != "0"


@dataclass
class PodData:
    requests: dict
    requirements: Requirements
    strict_requirements: Requirements
    # volume topology requirement alternatives (scheduler.go:222) and the
    # pod's PVC volumes grouped by driver for limit tracking (scheduler.go:623)
    volume_requirements: list = field(default_factory=list)
    volumes: dict = field(default_factory=dict)
    # DRA: the pod's resolved ResourceClaims (scheduler.go PodData
    # ResourceClaims/HasResourceClaimRequests/ResourceClaimErr)
    resource_claims: list = field(default_factory=list)
    resource_claim_err: str | None = None


@dataclass
class Results:
    """Outcome of a Solve (scheduler.go Results)."""

    new_node_claims: list[SchedulingNodeClaim] = field(default_factory=list)
    existing_nodes: list[ExistingNode] = field(default_factory=list)
    pod_errors: dict = field(default_factory=dict)  # pod key -> error string
    timed_out: bool = False
    # effective-zone label -> pending pod count (scheduler.go:453-459,495-501);
    # None = the producing backend did not compute it
    pending_pods_by_effective_zone: dict | None = None

    def all_pods_scheduled(self) -> bool:
        return not self.pod_errors

    def non_pending_pod_scheduling_errors(self) -> str:
        return "; ".join(f"{k}: {v}" for k, v in self.pod_errors.items())

    def node_pod_count(self) -> dict[str, int]:
        out = {}
        for n in self.existing_nodes:
            if n.pods:
                out[n.name()] = len(n.pods)
        return out

    def total_new_nodes(self) -> int:
        return len(self.new_node_claims)


# fit-memo entry cap (signatures x nodes scaling; see Scheduler._fit_memo)
_FIT_MEMO_MAX = 100_000


class SchedulerRoundSeed:
    """Cross-build carry for one consolidation round's host schedulers.

    A round runs many probe simulations; each builds a fresh Scheduler over
    almost the same cluster state. Three layers are PROBE-INVARIANT and carry
    across builds:

      - pod_data_templates: signature -> shared PodData (pure function of the
        pod content + store/policy, both fixed within a round);
      - sig_by_uid: pod uid -> signature (recomputed per solve anyway — the
        carry just skips re-deriving the signature string);
      - static_rejects: (signature, node name) -> error, recorded ONLY when
        the verdict was derived at the node's INITIAL state
        (node._version == 0). A version-0 node is identical in every probe
        that includes it (ExistingNode is rebuilt from the same StateNode),
        so the rejection is sound to pre-seed — mid-probe rejects (version
        > 0) depend on that probe's placements and are never recorded.

    The 15s command Validator never receives a seed: executed commands always
    re-validate against a fully independent from-scratch simulation."""

    def __init__(self):
        self.pod_data_templates: dict = {}
        self.sig_by_uid: dict = {}
        self.static_rejects: dict = {}
        self.seeded = 0  # rejects pre-seeded into the newest build (observability)


class Scheduler:
    def __init__(
        self,
        store,
        cluster,
        node_pools: list,
        instance_types: dict[str, list],  # nodepool name -> instance types
        state_nodes: list,
        daemonset_pods: list,
        clock,
        preference_policy: str = "Respect",
        min_values_policy: str = "Strict",
        enforce_consolidate_after: bool = False,
        deleting_node_names: set[str] | None = None,
        timeout_seconds: float = 60.0,
        dra_enabled: bool = False,
        reserved_capacity_enabled: bool = True,
        reserved_offering_mode: str = "fallback",
        collect_zone_metrics: bool = True,
        registry=None,
        ffd_batch: bool | None = None,
        round_seed: "SchedulerRoundSeed | None" = None,
    ):
        self.store = store
        self.cluster = cluster
        self.clock = clock
        self.preference_policy = preference_policy
        self.collect_zone_metrics = collect_zone_metrics
        self.min_values_policy = min_values_policy
        self.deleting_node_names = deleting_node_names or set()
        self.timeout_seconds = timeout_seconds
        self.registry = registry
        # KARPENTER_FFD_BATCH=1 (default): signature-batched FFD — per-solve
        # fit memo + placement cursors + PodData template cache + incremental
        # claim ordering. =0 is the exact-reference escape hatch; placements
        # are bit-identical either way (tests/test_ffd_batch.py).
        if ffd_batch is None:
            ffd_batch = _ffd_batch_enabled()
        self.batch_enabled = ffd_batch
        # fit memo: (pod signature, id(node|claim|template)) ->
        #   ("reject", err)          permanent monotone rejection
        #   ("pass", version, base)  static prefix passed at that state version
        # Unlike the per-pod-bounded caches below, entries scale with
        # signatures x nodes — capped like the filter cache so a unique-
        # signature flood (e.g. per-pod StatefulSet labels) can't balloon it;
        # clearing only forgets memoized verdicts, never invalidates cursors
        # (the underlying rejections stay permanent regardless)
        self._fit_memo: dict = {}
        # per-signature scan cursor over the (fixed-order) existing-node list:
        # every node before the cursor holds a permanent rejection for the sig
        self._existing_cursor: dict = {}
        # consolidation-round carry (SchedulerRoundSeed): probe-invariant
        # layers shared across this round's scheduler builds
        self._round_seed = round_seed if self.batch_enabled else None
        # signature -> shared PodData template (volume/port/DRA-free pods)
        self._pod_data_templates: dict = {} if self._round_seed is None else self._round_seed.pod_data_templates
        # pod uid -> signature tuple (None = pod bypasses the batched path)
        self._sig_by_uid: dict = {} if self._round_seed is None else self._round_seed.sig_by_uid
        # signature -> effective zone; valid ONLY during the pre-solve metric
        # loop (no placements happen there, so topology state is frozen)
        self._zone_by_sig: dict = {}
        self.memo_stats = {"hit": 0, "miss": 0, "invalidate": 0}
        self.phase_seconds = {"existing": 0.0, "inflight": 0.0, "new_claim": 0.0}
        # the PreferNoSchedule toleration relaxation arms whenever some pool
        # taints with that effect (scheduler.go:144-153 — policy-independent)
        self.preferences = Preferences(
            tolerate_prefer_no_schedule=pools_taint_prefer_no_schedule(node_pools)
            or (preference_policy == "Ignore")
        )
        self.cached_pod_data: dict[str, PodData] = {}
        # solve-scoped filter_instance_types memo shared by every claim
        # (nodeclaim.filter_instance_types_cached): identical pod signatures
        # probing the same claim state skip the full-catalog scan
        self.filter_cache: dict = {}
        self.volume_topology = VolumeTopology(store)
        # one DRA allocator per solve, shared by every candidate (provisioner.go:333-344)
        self.allocator = None
        if dra_enabled:
            from ....scheduling.dynamicresources import Allocator

            self.allocator = Allocator(store, clock)

        # one ReservationManager per solve, shared by every claim so reserved
        # capacity is bounded ACROSS claims (scheduler.go:186, NewScheduler)
        self.reservation_manager = None
        self.reserved_offering_mode = reserved_offering_mode
        if reserved_capacity_enabled:
            from .reservationmanager import ReservationManager

            self.reservation_manager = ReservationManager(instance_types)
            if not self.reservation_manager.capacity:
                # no reserved offerings anywhere: skip the per-can_add
                # offering scan entirely (same guard the TPU decode applies)
                self.reservation_manager = None

        # NodePools ordered by weight desc (provisioner.go:268-289)
        pools = sorted(node_pools, key=lambda np: (-np.spec.weight, np.metadata.name))
        self.templates: list[NodeClaimTemplate] = []
        for np in pools:
            t = NodeClaimTemplate(np)
            its = [it for it in instance_types.get(np.metadata.name, []) if _template_compatible(t, it)]
            if not its:
                continue
            t.instance_type_options = its
            self.templates.append(t)

        # remaining resources per nodepool for limit enforcement: start from the
        # raw limits; each state node is subtracted exactly once below
        # (scheduler.go:183-185, 840)
        self.remaining_resources: dict[str, dict[str, Quantity]] = {}
        for np in pools:
            if np.spec.limits:
                self.remaining_resources[np.metadata.name] = {k: Quantity(v.milli) for k, v in np.spec.limits.items()}

        self.topology = Topology(
            store,
            cluster,
            state_nodes,
            pools,
            instance_types,
            pods=[],
            preference_policy=preference_policy,
        )

        # daemon overhead groups per template (scheduler.go:963-1004)
        self.daemon_overhead_groups: dict[int, list[DaemonOverheadGroup]] = {}
        self.daemonset_pods = daemonset_pods
        for t in self.templates:
            self.daemon_overhead_groups[id(t)] = _compute_daemon_overhead_groups(t, daemonset_pods)

        nodepool_map = {np.metadata.name: np for np in pools}
        self.existing_nodes: list[ExistingNode] = []
        for sn in sorted(state_nodes, key=lambda n: n.name()):
            taints = sn.taints()
            daemons = [
                d
                for d in daemonset_pods
                if _daemon_compatible_with_node(sn, taints, d)
            ]
            under_ca = False
            if enforce_consolidate_after and sn.node_claim is not None:
                np = nodepool_map.get(sn.nodepool_name())
                under_ca = _is_under_consolidate_after(np, sn.node_claim, clock)
            self.existing_nodes.append(
                ExistingNode(sn, self.topology, taints, res.requests_for_pods(daemons), under_ca, allocator=self.allocator, daemon_pods=daemons)
            )
            self._update_remaining_resources(sn)

        # pre-seed the fit memo from the round carry: every recorded
        # version-0 static reject of a node this build still holds is
        # identical here (same StateNode, same initial ExistingNode state)
        if self._round_seed is not None and self._round_seed.static_rejects:
            by_name = {en.state_node.name(): en for en in self.existing_nodes}
            n_seeded = 0
            for (sig, node_name), err in self._round_seed.static_rejects.items():
                en = by_name.get(node_name)
                if en is not None:
                    self._memo_put((sig, id(en)), ("reject", err))
                    n_seeded += 1
            self._round_seed.seeded = n_seeded

        self.new_node_claims: list[SchedulingNodeClaim] = []

    def _update_remaining_resources(self, sn) -> None:
        pool = sn.nodepool_name()
        if pool in self.remaining_resources:
            self.remaining_resources[pool] = res.subtract(self.remaining_resources[pool], sn.capacity())

    # -- the solve loop (scheduler.go:440-494) ---------------------------------
    def compute_effective_zone_from_pod(self, pod) -> str:
        """The pod's effective zone constraint: the intersection of its
        node-selector zone signals, volume zone requirements, and zone
        topology-spread valid domains — a concrete zone name when exactly one
        survives, "flexible" for several, "none" for an empty intersection
        (scheduler.go:860-908 computeEffectiveZoneFromPod)."""
        pod_data = self.cached_pod_data[pod.metadata.uid]
        tsc_zones, satisfiable = self.topology.get_topology_zone_constraints(pod, pod_data.requirements)
        if not satisfiable:
            return "none"
        zone_req = pod_data.strict_requirements.get(wk.ZONE_LABEL_KEY)
        vol_zone_req = _volume_zone_req(pod_data.volume_requirements)
        if zone_req.operator() == Operator.IN:
            zonal_values = zone_req.values_list()
        elif vol_zone_req is not None:
            zonal_values = vol_zone_req.values_list()
        elif tsc_zones is not None:
            zonal_values = sorted(tsc_zones)
        else:
            return "flexible"
        matched = [
            z
            for z in zonal_values
            if zone_req.has(z)
            and (vol_zone_req is None or vol_zone_req.has(z))
            and (tsc_zones is None or z in tsc_zones)
        ]
        if len(matched) == 1:
            return matched[0]
        return "flexible" if len(matched) > 1 else "none"

    def solve(self, pods: list) -> Results:
        pod_errors: dict[str, tuple] = {}  # uid -> (pod, error)
        self.topology.prepare(pods)
        from ....apis.capacitybuffer import is_virtual_pod

        # the zone memo is only valid while topology counts are frozen; a
        # reused Scheduler re-enters with counts from the previous solve.
        # Template rejections were memoized under "no topology group
        # constrains this signature" — a new pod set can add inverse groups,
        # so they reset per solve too (no-op for the usual one-solve life)
        self._zone_by_sig.clear()
        if self._fit_memo:
            tmpl_ids = {id(t) for t in self.templates}
            self._fit_memo = {k: v for k, v in self._fit_memo.items() if k[1] not in tmpl_ids}
        # per-solve observability (flushed to the registry once per solve)
        self.memo_stats = {"hit": 0, "miss": 0, "invalidate": 0}
        self.phase_seconds = {"existing": 0.0, "inflight": 0.0, "new_claim": 0.0}
        pods_by_zone: dict[str, int] | None = None
        if self.collect_zone_metrics:
            pods_by_zone = {}
        for p in pods:
            self._update_cached_pod_data(p)
            # buffer virtual pods are headroom, not demand — the reference's
            # count excludes them via the phase guard (virtual pods carry no
            # phase there, buffers.go:140-148; scheduler.go:455-459);
            # consolidation simulations skip the computation entirely
            if (
                pods_by_zone is not None
                and p.status.phase in ("", "Pending")
                and not is_virtual_pod(p)
            ):
                # no placement happens until the queue loop below, so the
                # effective zone is a pure function of the pod signature here
                sig = self._sig_by_uid.get(p.metadata.uid)
                zone = self._zone_by_sig.get(sig) if sig is not None else None
                if zone is None:
                    zone = self.compute_effective_zone_from_pod(p)
                    if sig is not None:
                        self._zone_by_sig[sig] = zone
                pods_by_zone[zone] = pods_by_zone.get(zone, 0) + 1

        if self.batch_enabled:
            # establish the fewest-pods-first invariant once (adopted in-flight
            # claims from a hybrid residual arrive unsorted); every later add
            # repositions exactly one claim, so the reference's per-_add resort
            # reduces to an O(shift) bubble
            self.new_node_claims.sort(key=lambda m: len(m.pods))

        q = Queue(pods, self.cached_pod_data)
        start = self.clock.now()
        timed_out = False
        while True:
            pod = q.pop()
            if pod is None:
                break
            if self.clock.now() - start > self.timeout_seconds:
                # surface every unattempted pod so callers never mistake a
                # partial simulation for a complete one (scheduler.go:520)
                timed_out = True
                pod_errors[pod.metadata.uid] = (pod, "scheduling simulation timed out")
                for rest in q.list():
                    pod_errors.setdefault(rest.metadata.uid, (rest, "scheduling simulation timed out"))
                break
            err = self._try_schedule(pod)
            if err is not None:
                pod_errors[pod.metadata.uid] = (pod, err)
                self.topology.update(pod)
                self._update_cached_pod_data(pod)
                q.push(pod)
            else:
                pod_errors.pop(pod.metadata.uid, None)

        for nc in self.new_node_claims:
            nc.finalize()

        if self.registry is not None:
            self._flush_solve_metrics()
        self._flush_trace()

        return Results(
            new_node_claims=list(self.new_node_claims),
            existing_nodes=list(self.existing_nodes),
            pod_errors={p.key(): e for p, e in pod_errors.values()},
            timed_out=timed_out,
            pending_pods_by_effective_zone=pods_by_zone,
        )

    def _flush_solve_metrics(self) -> None:
        from .... import metrics as m

        memo = self.registry.counter(m.SOLVER_FFD_MEMO_TOTAL)
        memo.inc(self.memo_stats["hit"], kind="hit")
        memo.inc(self.memo_stats["miss"], kind="miss")
        memo.inc(self.memo_stats["invalidate"], kind="invalidate")
        phases = self.registry.histogram(m.SOLVER_FFD_PHASE_SECONDS)
        phases.observe(self.phase_seconds["existing"], phase="existing")
        phases.observe(self.phase_seconds["inflight"], phase="inflight")
        phases.observe(self.phase_seconds["new_claim"], phase="new_claim")

    def _flush_trace(self) -> None:
        """Attach this solve's per-phase split and fit-memo attribution to
        the ambient SolveTrace, if one is active (a GPU fallback/residual or
        a flight-recorded FFD solve). The per-pod phase accumulation itself
        stays counter-based — a span per pod would be the overhead the trace
        layer promises not to add — so the totals land as back-dated spans."""
        from ....obs.trace import current_trace

        tr = current_trace()
        if tr is None or not tr.enabled:
            return
        for phase in ("existing", "inflight", "new_claim"):
            tr.add_phase(f"ffd.{phase}", self.phase_seconds[phase])
        tr.note(ffd_memo=dict(self.memo_stats))

    def _memo_put(self, key, entry) -> None:
        memo = self._fit_memo
        if len(memo) >= _FIT_MEMO_MAX:
            memo.clear()  # bound memory; verdicts re-derive on demand
        memo[key] = entry

    def _cacheable_sig(self, pod):
        """The pod's scheduling signature, or None when the pod must bypass
        the batched fast path: bound pods (node_name feeds the existing-node
        scan's consolidate-after skip), DRA pods, PVC/ephemeral-volume pods
        (claim NAMES are not part of the signature but select distinct PVC
        objects), and host-port pods (their conflict checks read mutable
        usage state the signature cannot see) — the same exclusions as
        filter_instance_types_cached."""
        spec = pod.spec
        if spec.node_name or spec.resource_claims:
            return None
        for v in spec.volumes:
            if v.get("persistentVolumeClaim") or v.get("ephemeral") is not None:
                return None
        from ....scheduling.hostports import pod_host_ports

        if pod_host_ports(pod):
            return None
        from ....solver.encode import pod_signature  # lazy: encode imports this module

        return pod_signature(pod)

    def _update_cached_pod_data(self, pod) -> None:
        if self.batch_enabled:
            sig = self._cacheable_sig(pod)
            self._sig_by_uid[pod.metadata.uid] = sig
            if sig is not None:
                data = self._pod_data_templates.get(sig)
                if data is None:
                    data = self._pod_data_templates[sig] = self._build_pod_data(pod)
                self.cached_pod_data[pod.metadata.uid] = data
                return
        self.cached_pod_data[pod.metadata.uid] = self._build_pod_data(pod)

    def _build_pod_data(self, pod) -> PodData:
        if self.preference_policy == "Ignore":
            requirements = Requirements.from_pod(pod, strict=True)
        else:
            requirements = Requirements.from_pod(pod)
        strict = requirements
        aff = pod.spec.affinity.node_affinity if pod.spec.affinity else None
        if aff is not None and aff.preferred:
            strict = Requirements.from_pod(pod, strict=True)
        claims, claim_err = [], None
        if self.allocator is not None and pod.spec.resource_claims:
            from ....scheduling.dynamicresources import resolve_pod_claims

            claims, claim_err = resolve_pod_claims(self.store, pod)
            claims = claims or []  # claim_err is carried separately and fails CanAdd
        return PodData(
            requests=res.pod_requests(pod),
            requirements=requirements,
            strict_requirements=strict,
            volume_requirements=self.volume_topology.get_requirements(pod),
            volumes=get_volumes(self.store, pod),
            resource_claims=claims,
            resource_claim_err=claim_err,
        )

    def _try_schedule(self, pod) -> str | None:
        """Relaxation loop (scheduler.go:521-552). The pod is copied lazily —
        only right before the first relaxation mutates its spec — so the
        dominant first-attempt success never pays the deepcopy, and the
        caller's original stays pristine either way."""
        import copy

        relaxed = False
        while True:
            err = self._add(pod)
            if err is None:
                return None
            if not relaxed:
                pod = copy.deepcopy(pod)
                relaxed = True
            if not self.preferences.relax(pod):
                return err
            self.topology.update(pod)
            self._update_cached_pod_data(pod)

    def _add(self, pod) -> str | None:
        t0 = time.perf_counter()
        err = self._add_to_existing_node(pod)
        t1 = time.perf_counter()
        self.phase_seconds["existing"] += t1 - t0
        if err is None:
            return None
        if not self.batch_enabled:
            # inflight claims sorted fewest-pods-first (scheduler.go:598); the
            # batched path maintains this invariant incrementally instead
            self.new_node_claims.sort(key=lambda m: len(m.pods))
        err = self._add_to_inflight_node(pod)
        t2 = time.perf_counter()
        self.phase_seconds["inflight"] += t2 - t1
        if err is None:
            return None
        if not self.templates:
            return "nodepool requirements filtered out all available instance types"
        err = self._add_to_new_node_claim(pod)
        self.phase_seconds["new_claim"] += time.perf_counter() - t2
        return err

    def _add_to_existing_node(self, pod) -> str | None:
        pod_data = self.cached_pod_data[pod.metadata.uid]
        is_pending = not pod.spec.node_name
        sig = self._sig_by_uid.get(pod.metadata.uid) if self.batch_enabled else None
        nodes = self.existing_nodes
        landed = None
        # placement cursor: every node before it permanently rejected this
        # signature, so an identical pod resumes where the last one got to
        start = self._existing_cursor.get(sig, 0) if sig is not None else 0
        if start:
            self.memo_stats["hit"] += start  # cursor-skipped permanent rejections
        for i in range(start, len(nodes)):
            node = nodes[i]
            if node.is_under_consolidate_after and not is_pending and pod.spec.node_name not in self.deleting_node_names:
                continue
            if sig is None:
                reqs, err = node.can_add(pod, pod_data)
                if err is None:
                    node.add(pod, pod_data, reqs)
                    return None
                continue
            key = (sig, id(node))
            ent = self._fit_memo.get(key)
            if ent is not None and ent[0] == "reject":
                self.memo_stats["hit"] += 1
                continue
            if ent is not None and ent[1] == node._version:
                self.memo_stats["hit"] += 1
                base = ent[2]
            else:
                if ent is not None:
                    self.memo_stats["invalidate"] += 1
                else:
                    self.memo_stats["miss"] += 1
                base, err = node.can_add_static(pod, pod_data)
                if err is not None:
                    # every static check is monotone within the solve
                    # (existingnode.can_add_static): cache forever
                    self._memo_put(key, ("reject", err))
                    if self._round_seed is not None and node._version == 0:
                        # derived at the node's INITIAL state: probe-invariant
                        # within the round — record it for the next build
                        self._round_seed.static_rejects[(sig, node.state_node.name())] = err
                    continue
                self._memo_put(key, ("pass", node._version, base))
            reqs, err = node.can_add_dynamic(pod, pod_data, base)
            if err is None:
                node.add(pod, pod_data, reqs)
                landed = i
                break
        if sig is not None:
            c = self._existing_cursor.get(sig, 0)
            while c < len(nodes):
                ent = self._fit_memo.get((sig, id(nodes[c])))
                if ent is None or ent[0] != "reject":
                    break
                c += 1
            self._existing_cursor[sig] = c
        if landed is not None:
            return None
        return "failed scheduling pod to existing nodes"

    def _add_to_inflight_node(self, pod) -> str | None:
        # the in-flight "cursor" is the memo itself: claims re-order as their
        # pod counts move (fewest-first), so a positional resume point is
        # unsound here — instead every permanently-rejected claim costs one
        # dict lookup and everything else resumes exactly where the last
        # identical pod left its verdicts
        pod_data = self.cached_pod_data[pod.metadata.uid]
        sig = self._sig_by_uid.get(pod.metadata.uid) if self.batch_enabled else None
        claims = self.new_node_claims
        for i in range(len(claims)):
            nc = claims[i]
            if sig is None:
                # in-flight claims never relax minValues (scheduler.go:669)
                reqs, its, err = nc.can_add(pod, pod_data, relax_min_values=False)
            else:
                key = (sig, id(nc))
                ent = self._fit_memo.get(key)
                if ent is not None and ent[0] == "reject":
                    self.memo_stats["hit"] += 1
                    continue
                if ent is not None and ent[1] == nc._version:
                    self.memo_stats["hit"] += 1
                    base = ent[2]
                else:
                    if ent is not None:
                        self.memo_stats["invalidate"] += 1
                    else:
                        self.memo_stats["miss"] += 1
                    base, serr = nc.can_add_static(pod, pod_data)
                    if serr is not None:
                        # taints are fixed and claim requirements only ever
                        # tighten: a static rejection is permanent
                        self._memo_put(key, ("reject", serr))
                        continue
                    self._memo_put(key, ("pass", nc._version, base))
                reqs, its, err, permanent = nc.can_add_dynamic(pod, pod_data, base, relax_min_values=False)
                if err is not None and permanent:
                    # capacity-exhausted: no option of this claim has the raw
                    # resources for its accumulated requests plus this pod —
                    # monotone regardless of topology/reservation churn
                    self._memo_put(key, ("reject", err))
            if err is None:
                nc.add(pod, pod_data, reqs, its)
                if self.batch_enabled:
                    self._bubble_claim_right(i)
                return None
        return "failed scheduling pod to inflight nodes"

    def _add_to_new_node_claim(self, pod) -> str | None:
        pod_data = self.cached_pod_data[pod.metadata.uid]
        sig = self._sig_by_uid.get(pod.metadata.uid) if self.batch_enabled else None
        errs = []
        for t in self.templates:
            its = t.instance_type_options
            remaining = self.remaining_resources.get(t.nodepool_name)
            # nodepool limits make the option set probe-dependent, so template
            # rejections are only memoized for unlimited pools (the memoized
            # error string must be exactly reproducible)
            memo_key = (sig, id(t)) if sig is not None and remaining is None else None
            if memo_key is not None:
                ent = self._fit_memo.get(memo_key)
                if ent is not None:
                    self.memo_stats["hit"] += 1
                    errs.append(ent[1])
                    continue
            if remaining is not None:
                nodes_left = remaining.get("nodes")
                if nodes_left is not None and nodes_left.milli <= 0:
                    errs.append(f"node limits exhausted for nodepool {t.nodepool_name}")
                    continue
                its = _filter_by_remaining_resources(its, remaining)
                if not its:
                    errs.append(f"all available instance types exceed limits for nodepool {t.nodepool_name}")
                    continue
            nc = SchedulingNodeClaim(
                t,
                self.topology,
                self.daemon_overhead_groups[id(t)],
                its,
                allocator=self.allocator,
                reservation_manager=self.reservation_manager,
                reserved_offering_mode=self.reserved_offering_mode,
                filter_cache=self.filter_cache,
            )
            relax = self.min_values_policy == "BestEffort"
            if memo_key is None:
                reqs, rem_its, err = nc.can_add(pod, pod_data, relax_min_values=relax)
            else:
                base, err = nc.can_add_static(pod, pod_data)
                permanent = err is not None  # static rejections are permanent
                if err is None:
                    reqs, rem_its, err, permanent = nc.can_add_dynamic(pod, pod_data, base, relax_min_values=relax)
                if err is not None and permanent and not self.topology._matching_topologies(pod, t.taints, base or nc.requirements):
                    # a fresh claim's probe is state-independent when no
                    # topology group constrains the pod: the exact error
                    # string reproduces on every later probe, so memoize it
                    # (pod_errors stay bit-identical to the unbatched path)
                    self._memo_put(memo_key, ("reject", f"{t.nodepool_name}: {err}"))
            if err is not None:
                errs.append(f"{t.nodepool_name}: {err}")
                continue
            nc.add(pod, pod_data, reqs, rem_its)
            self.new_node_claims.append(nc)
            if self.batch_enabled:
                self._bubble_claim_left()
            if remaining is not None:
                self.remaining_resources[t.nodepool_name] = _subtract_max(remaining, nc.instance_type_options)
            return None
        return "; ".join(errs) if errs else "no nodepool matched pod"

    # -- incremental fewest-pods-first maintenance -----------------------------
    # One add changes exactly one claim's pod count; relocating just that claim
    # reproduces what the reference's per-_add stable sort would compute.

    def _bubble_claim_right(self, i: int) -> None:
        """Claim i gained a pod: move it right past claims with strictly fewer
        pods (stable order among equal counts is preserved, matching
        list.sort)."""
        claims = self.new_node_claims
        c = claims[i]
        k = len(c.pods)
        j = i
        while j + 1 < len(claims) and len(claims[j + 1].pods) < k:
            claims[j] = claims[j + 1]
            j += 1
        claims[j] = c

    def _bubble_claim_left(self) -> None:
        """A claim was appended: move it left past claims with strictly more
        pods (it stays after equal counts, exactly where a stable sort of
        append-then-sort would place it)."""
        claims = self.new_node_claims
        j = len(claims) - 1
        c = claims[j]
        k = len(c.pods)
        while j > 0 and len(claims[j - 1].pods) > k:
            claims[j] = claims[j - 1]
            j -= 1
        claims[j] = c


def _volume_zone_req(volume_reqs: list) -> Requirement | None:
    """Union of zone constraints across the pod's volume requirement
    alternatives, or None when volumes don't constrain zones — any
    zone-unconstrained alternative (operator != In, since
    VolumeTopology.get_requirements normalizes alternatives to Requirements)
    unconstrains the whole pod (scheduler.go:910-936 volumeZoneReq)."""
    if not volume_reqs:
        return None
    values: set[str] = set()
    for vol in volume_reqs:
        req = vol.get(wk.ZONE_LABEL_KEY)
        if req.operator() != Operator.IN:
            return None
        values |= set(req.values_list())
    return Requirement(wk.ZONE_LABEL_KEY, Operator.IN, sorted(values))


def _template_compatible(template: NodeClaimTemplate, it) -> bool:
    """Instance type passes the template requirements and has an offering."""
    if it.requirements.intersects(template.requirements) is not None:
        return False
    return any(o.available and template.requirements.intersects(o.requirements) is None for o in it.offerings)


def _compute_daemon_overhead_groups(template: NodeClaimTemplate, daemonset_pods: list) -> list[DaemonOverheadGroup]:
    """Group instance types by which daemons would schedule to them
    (scheduler.go:963-1004): the daemon overhead depends on daemon
    nodeSelector/affinity/taints vs the concrete instance type."""
    groups: dict[tuple, DaemonOverheadGroup] = {}
    for it in template.instance_type_options:
        compatible: list = []
        for d in daemonset_pods:
            if _daemon_compatible_with_instance_type(template, it, d):
                compatible.append(d)
        key = tuple(sorted(id(d) for d in compatible))
        g = groups.get(key)
        if g is None:
            overhead = res.requests_for_pods(compatible)
            g = DaemonOverheadGroup(instance_types=[], daemon_overhead=overhead)
            # daemons reserve their host ports on every fresh node of this
            # group (suite_test.go:955 "should account for daemonset
            # hostports": a pod sharing the port can never schedule there)
            from ....scheduling.hostports import pod_host_ports

            for d in compatible:
                g.host_port_usage.add(d.key(), pod_host_ports(d))
            groups[key] = g
        g.instance_types.append(it)
    return list(groups.values())


def _daemon_requirement_alternatives(daemon_pod) -> list[Requirements]:
    """Node-selector + each required node-affinity OR-term — the reference
    relaxes daemons across all OR-terms (isDaemonPodCompatible,
    scheduler.go:1023-1040), so a daemon counts if ANY term matches."""
    base = Requirements.from_labels(daemon_pod.spec.node_selector)
    aff = daemon_pod.spec.affinity.node_affinity if daemon_pod.spec.affinity else None
    if aff is None or not aff.required:
        return [base]
    out = []
    for term in aff.required:
        r = base.copy()
        r.add(*Requirements.from_node_selector_terms(term).values())
        out.append(r)
    return out


def _daemon_compatible_with_instance_type(template: NodeClaimTemplate, it, daemon_pod) -> bool:
    """Requirements/taints only — the reference deliberately does NOT check
    resource fit (isDaemonPodCompatible, scheduler.go:1020-1043): an
    oversized daemon still counts as overhead, rendering the instance type
    unable to host anything (suite_test.go:1003)."""
    if taints_tolerate_pod(template.taints, daemon_pod) is not None:
        return False
    reqs = Requirements()
    reqs.add(*template.requirements.values())
    reqs.add(*it.requirements.values())
    return any(
        reqs.compatible(alt, allow_undefined=wk.WELL_KNOWN_LABELS) is None
        for alt in _daemon_requirement_alternatives(daemon_pod)
    )


def _daemon_compatible_with_node(sn, taints, daemon_pod) -> bool:
    if taints_tolerate_pod(taints, daemon_pod) is not None:
        return False
    node_reqs = Requirements.from_labels(sn.labels())
    return any(node_reqs.compatible(alt) is None for alt in _daemon_requirement_alternatives(daemon_pod))


def _filter_by_remaining_resources(its: list, remaining: dict[str, Quantity]) -> list:
    """Drop instance types that would exceed the nodepool limits; only the
    limited resource names are consulted (scheduler.go:1069-1085)."""
    out = []
    for it in its:
        if all(it.capacity.get(k, Quantity(0)).milli <= v.milli for k, v in remaining.items()):
            out.append(it)
    return out


def _subtract_max(remaining: dict[str, Quantity], its: list) -> dict[str, Quantity]:
    """Subtract the worst-case capacity of the chosen instance types, keyed by
    the limited resources (scheduler.go:1049-1066). We additionally decrement
    the synthetic "nodes" resource by 1 per in-flight claim — the reference
    gates node limits via the early IsZero check plus existing-node counting."""
    worst: dict[str, Quantity] = {}
    for it in its:
        for k, v in it.capacity.items():
            if k not in worst or v.milli > worst[k].milli:
                worst[k] = v
    out = {k: v - worst.get(k, Quantity(0)) for k, v in remaining.items()}
    if "nodes" in remaining:
        out["nodes"] = remaining["nodes"] - Quantity.parse(1)
    return out


def _is_under_consolidate_after(np, node_claim, clock) -> bool:
    """IsUnderConsolidateAfter (utils/disruption.go:80-100): node had pod churn
    more recently than consolidateAfter allows."""
    if np is None or node_claim is None:
        return False
    ca = np.spec.disruption.consolidate_after_seconds()
    if ca == 0 or ca == math.inf:
        return False
    from ....apis.nodeclaim import COND_INITIALIZED

    cond = node_claim.status.conditions.get(COND_INITIALIZED)
    if cond is None or cond.status != "True":
        return False
    base = node_claim.status.last_pod_event_time or cond.last_transition_time
    return clock.now() - base < ca
