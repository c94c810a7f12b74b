"""FFDSolver: the exact host scheduler behind the Solver interface.

Signature-batched FFD: every host-scheduler consumer gets the fast path
through `build_scheduler`. The monotonicity argument the per-solve fit memo
relies on:

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

from ..controllers.provisioning.scheduling import Results, Scheduler
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
    )


class FFDSolver:
    name = "ffd"

    def __init__(self):
        # per-solve observability snapshots (bench + dashboards). Only the two
        # small dicts are kept — retaining the Scheduler itself would pin the
        # whole solve's state (memo, caches, claims) for the solver's lifetime
        self.last_memo_stats: dict | None = None
        self.last_phase_seconds: dict | None = None

    def solve(self, snap: SolverSnapshot) -> Results:
        # the reference also flight-records a standalone solve into its
        # SolveTrace ring; the port has no trace recorder yet
        scheduler = build_scheduler(snap)
        try:
            return scheduler.solve(snap.pods)
        finally:
            self.last_memo_stats = dict(scheduler.memo_stats)
            self.last_phase_seconds = dict(scheduler.phase_seconds)

