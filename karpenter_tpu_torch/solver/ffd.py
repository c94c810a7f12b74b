"""FFDSolver: the exact host scheduler behind the Solver interface, plus the
residual path — the same Scheduler run against a node state pre-seeded with
a tensor solve's placements (the decode's minValues repair).

Signature-batched FFD (KARPENTER_FFD_BATCH=1, default on; =0 is the exact-
reference escape hatch, read by each `Scheduler` built, placements
bit-identical either way). Every host-scheduler consumer — the full
fallback, `solve_residual` (the hybrid tail and the decode repair), and the
consolidation simulations — gets the fast path through `build_scheduler`.
The monotonicity argument the per-solve fit memo relies on:

  Within one `Scheduler.solve()`, node labels/taints are fixed and node state
  only ever TIGHTENS — remaining resources shrink, requirements narrow (add()
  intersects), port/volume usage accumulates, in-flight instance-type options
  narrow, accumulated requests grow. Hence a rejection of scheduling-signature
  S by node N from the static prefix (taints / volume limits / host ports /
  resource fit / requirements compatibility) or from raw capacity exhaustion
  (no option has the resources for the accumulated requests plus S) can never
  become an acceptance later: it is memoized permanently per (signature, node).
  Only topology (skew counts move both ways as pods land) and reservation
  state (releases re-open options) are genuinely non-monotone; those checks
  run AFTER the memoizable prefix on every probe, and a static pass is
  stamped with the node's state version so any tightening re-validates it.
  Preference relaxation deep-copies and mutates the pod spec, which changes
  its signature — relaxed pods re-key the memo naturally."""

from __future__ import annotations

from ..apis import labels as wk
from ..controllers.provisioning.scheduling import Results, Scheduler
from ..controllers.provisioning.scheduling.scheduler import _subtract_max
from ..scheduling.hostports import pod_host_ports
from ..scheduling.requirements import Requirement
from ..scheduling.volumeusage import get_volumes
from ..utils import resources as res
from .snapshot import SolverSnapshot


def build_scheduler(snap: SolverSnapshot, collect_zone_metrics: bool | None = None) -> Scheduler:
    """One host Scheduler configured exactly from a SolverSnapshot."""
    return Scheduler(
        snap.store,
        snap.cluster,
        snap.node_pools,
        snap.instance_types,
        snap.state_nodes,
        snap.daemonset_pods,
        snap.clock,
        preference_policy=snap.preference_policy,
        min_values_policy=snap.min_values_policy,
        enforce_consolidate_after=snap.enforce_consolidate_after,
        deleting_node_names=snap.deleting_node_names,
        dra_enabled=snap.dra_enabled,
        reserved_capacity_enabled=snap.reserved_capacity_enabled,
        reserved_offering_mode=snap.reserved_offering_mode,
        collect_zone_metrics=snap.collect_zone_metrics if collect_zone_metrics is None else collect_zone_metrics,
        registry=getattr(snap, "registry", None),
        # consolidation rounds stamp a SchedulerRoundSeed on their probe
        # snapshots (helpers.simulate_scheduling): probe-invariant fit-memo/
        # PodData layers carry across the round's scheduler builds
        round_seed=getattr(snap, "sched_seed", None),
    )


class FFDSolver:
    name = "ffd"

    def solve(self, snap: SolverSnapshot) -> Results:
        from ..obs.trace import current_trace, default_recorder

        # flight-record standalone FFD solves. Inside a GPUSolver solve
        # (fallback/residual) a trace is already ambient and the Scheduler
        # attaches its phase split to it — don't nest.
        rec = trace = None
        if current_trace() is None:
            rec = default_recorder()
            trace = rec.begin(n_pods=len(snap.pods))
            trace.mode = "ffd"
            trace.backend = self.name
        try:
            return build_scheduler(snap).solve(snap.pods)
        finally:
            if rec is not None:
                rec.commit(trace, registry=getattr(snap, "registry", None))


def solve_residual(snap: SolverSnapshot, residual_pods: list, tensor_results: Results, seam_records: list) -> Results:
    """The residual tail: run the exact host Scheduler on `residual_pods`
    against the tensor result's node state — existing StateNodes pre-loaded
    with the tensor-placed pods, and the freshly decoded NodeClaims adopted
    as in-flight nodes the residual can schedule INTO (no
    double-provisioning). Returns the MERGED Results: the tensor claims
    (possibly holding residual pods now) plus any claims the residual opened,
    every existing node with both halves' pods, and the union of pod errors.

    `seam_records` exports the tensor side's topology occupancy across the
    partition seam: each record is one tensor-placed pod with its
    placement's (taints, concrete requirements), recorded into the residual
    Topology through the host's own counting rule — so a SPREAD group whose
    selector spans both halves sees the true combined per-domain counts
    (`GPUSolver._seam_records` builds the list)."""
    from ..obs.trace import trace_span

    with trace_span("ffd_adopt"):
        # the zone metric would cover only the residual half — skip computing
        # it and mark it uncomputed rather than misreported (Results contract)
        scheduler = build_scheduler(snap, collect_zone_metrics=False)
        _adopt_tensor_state(scheduler, snap, tensor_results)
        if seam_records:
            # build the residual pods' topology groups now so the records land
            # in them (prepare() is idempotent — scheduler.solve re-entering it
            # only re-registers owners). Adoption above already added hostname
            # requirements to the tensor claims, so hostname-keyed groups count.
            scheduler.topology.prepare(residual_pods)
            for pod, taints, reqs in seam_records:
                scheduler.topology.record(pod, taints, reqs)
    results = scheduler.solve(residual_pods)
    results.pod_errors.update(tensor_results.pod_errors)
    results.pending_pods_by_effective_zone = None
    return results


def _adopt_tensor_state(scheduler: Scheduler, snap: SolverSnapshot, tensor_results: Results) -> None:
    """Fold a tensor solve's placements into a fresh Scheduler's state."""
    # tensor-placed pods are pending (never bound in the store); exclude them
    # from store-side topology counting so they can never double-book — the
    # seam path counts them explicitly via `seam_records` instead, with the
    # placement's concrete requirements rather than a store lookup
    placed = [p for en in tensor_results.existing_nodes for p in en.pods]
    placed += [p for nc in tensor_results.new_node_claims for p in nc.pods]
    scheduler.topology.excluded_pods.update(p.metadata.uid for p in placed)

    en_by_name = {en.name(): en for en in scheduler.existing_nodes}
    for ten in tensor_results.existing_nodes:
        if not ten.pods:
            continue
        en = en_by_name[ten.name()]
        en.pods.extend(ten.pods)
        en.remaining_resources = res.subtract(en.remaining_resources, res.requests_for_pods(ten.pods))
        for pod in ten.pods:
            en.host_port_usage.add(pod.key(), pod_host_ports(pod))
            if snap.store is not None:
                en.volume_usage.add(pod.key(), get_volumes(snap.store, pod))

    for claim in tensor_results.new_node_claims:
        _adopt_claim(scheduler, claim)
        scheduler.new_node_claims.append(claim)


def _adopt_claim(scheduler: Scheduler, claim) -> None:
    """Rehydrate a decode-produced SchedulingNodeClaim into a live in-flight
    claim (the decode builds claims with `__new__` — no topology, DRA, or
    reservation plumbing — because the device result fully determines them),
    then book its placements into this solve's shared state."""
    claim.rehydrate(
        scheduler.topology,
        allocator=scheduler.allocator,
        reservation_manager=scheduler.reservation_manager,
        reserved_offering_mode=scheduler.reserved_offering_mode,
        filter_cache=scheduler.filter_cache,
    )
    for pod in claim.pods:
        ports = pod_host_ports(pod)
        if ports:
            for g in claim.daemon_overhead_groups:
                g.host_port_usage.add(pod.key(), ports)
    if claim.reserved_offerings and scheduler.reservation_manager is not None:
        # carry the decode-time reservations into this solve's manager so
        # residual claims can never oversubscribe them
        scheduler.reservation_manager.reserve(claim.hostname, *claim.reserved_offerings)
    # the in-flight hostname placeholder (dropped again by finalize());
    # registering it lets residual hostname-keyed groups see the open slot
    if not claim.requirements.has(wk.HOSTNAME_LABEL_KEY):
        claim.requirements.add(Requirement(wk.HOSTNAME_LABEL_KEY, "In", [claim.hostname]))
    scheduler.topology.register(wk.HOSTNAME_LABEL_KEY, claim.hostname)
    # nodepool limit accounting, exactly like _add_to_new_node_claim
    remaining = scheduler.remaining_resources.get(claim.nodepool_name)
    if remaining is not None:
        scheduler.remaining_resources[claim.nodepool_name] = _subtract_max(remaining, claim.instance_type_options)
