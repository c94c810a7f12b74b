"""Metrics registry + the well-known karpenter_ metric definitions.

Reference: pkg/metrics/metrics.go:36-107 and the per-controller metric files
(scheduling/metrics.go, disruption/metrics.go, controllers/metrics/*). The
names below match the reference's fully-qualified prometheus names.
"""

from __future__ import annotations

from .registry import (
    DEFAULT_BUCKETS,
    DURATION_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
)

# -- well-known metric names (reference: pkg/metrics/metrics.go) --------------
NODECLAIMS_CREATED_TOTAL = "karpenter_nodeclaims_created_total"
NODECLAIMS_TERMINATED_TOTAL = "karpenter_nodeclaims_terminated_total"
NODECLAIMS_DISRUPTED_TOTAL = "karpenter_nodeclaims_disrupted_total"
PODS_DISRUPTION_INITIATED_TOTAL = "karpenter_pods_disruption_initiated_total"
NODES_CREATED_TOTAL = "karpenter_nodes_created_total"
NODES_TERMINATED_TOTAL = "karpenter_nodes_terminated_total"

SCHEDULER_SCHEDULING_DURATION = "karpenter_scheduler_scheduling_duration_seconds"
SCHEDULER_QUEUE_DEPTH = "karpenter_scheduler_queue_depth"
SCHEDULER_UNFINISHED_WORK = "karpenter_scheduler_unfinished_work_seconds"
SCHEDULER_IGNORED_PODS = "karpenter_scheduler_ignored_pods_count"
SCHEDULER_UNSCHEDULABLE_PODS = "karpenter_scheduler_unschedulable_pods_count"
SCHEDULER_PENDING_PODS_BY_EFFECTIVE_ZONE = "karpenter_scheduler_pending_pods_by_effective_zone_count"

DISRUPTION_DECISIONS_TOTAL = "karpenter_voluntary_disruption_decisions_total"
DISRUPTION_ELIGIBLE_NODES = "karpenter_voluntary_disruption_eligible_nodes"
DISRUPTION_CONSOLIDATION_TIMEOUTS_TOTAL = "karpenter_voluntary_disruption_consolidation_timeouts_total"
DISRUPTION_FAILED_VALIDATIONS_TOTAL = "karpenter_voluntary_disruption_failed_validations_total"
DISRUPTION_QUEUE_FAILURES_TOTAL = "karpenter_voluntary_disruption_queue_failures_total"
DISRUPTION_DECISION_EVAL_DURATION = "karpenter_voluntary_disruption_decision_evaluation_duration_seconds"
NODEPOOL_ALLOWED_DISRUPTIONS = "karpenter_nodepools_allowed_disruptions"

PODS_STARTUP_DURATION = "karpenter_pods_startup_duration_seconds"
PODS_BOUND_DURATION = "karpenter_pods_bound_duration_seconds"
PODS_UNBOUND_TIME = "karpenter_pods_unbound_time_seconds"
PODS_PROVISIONING_BOUND_DURATION = "karpenter_pods_provisioning_bound_duration_seconds"
PODS_STATE = "karpenter_pods_state"

NODES_ALLOCATABLE = "karpenter_nodes_allocatable"
NODES_TOTAL_POD_REQUESTS = "karpenter_nodes_total_pod_requests"
NODES_TOTAL_DAEMON_REQUESTS = "karpenter_nodes_total_daemon_requests"
NODES_UTILIZATION = "karpenter_nodes_utilization_percent"
NODES_CURRENT_LIFETIME = "karpenter_nodes_current_lifetime_seconds"

NODEPOOL_USAGE = "karpenter_nodepools_usage"
NODEPOOL_LIMIT = "karpenter_nodepools_limit"
NODEPOOL_COST_TOTAL = "karpenter_nodepools_cost_total"
NODEPOOL_COST_TRACKER_ERRORS_TOTAL = "karpenter_nodepools_cost_tracker_errors_total"

CLUSTER_STATE_SYNCED = "karpenter_cluster_state_synced"
CLUSTER_STATE_NODE_COUNT = "karpenter_cluster_state_node_count"

# tensor-solver observability (no reference analogue — the FFD path *is* the
# semantics there; the TPU backend re-derives placements so it self-checks)
SOLVER_SOLVE_TOTAL = "karpenter_solver_solve_total"
SOLVER_FALLBACK_TOTAL = "karpenter_solver_fallback_total"
SOLVER_VALIDATION_FAILURES_TOTAL = "karpenter_solver_validation_failures_total"
SOLVER_HYBRID_RESIDUAL_TOTAL = "karpenter_solver_hybrid_residual_total"
SOLVER_DECODE_REPAIR_TOTAL = "karpenter_solver_decode_repair_total"
# decode materialization mode per solve; mode is the bounded {full,
# delta-reuse} enum — a warm delta chain should sit at delta-reuse
SOLVER_DECODE_TOTAL = "karpenter_solver_decode_total"
# per-slot reuse attribution: claims served from the decode-delta memo
# instead of re-materialized (the decode-tail analogue of delta-hit)
SOLVER_DECODE_REUSED_SLOTS_TOTAL = "karpenter_solver_decode_reused_slots_total"
# why a delta-capable solve routed to the full path anyway; reason is the
# bounded encode.DELTA_REJECT_REASONS enum ({unseen-sig, row-key, vol-rv,
# pvc, cap, reorder, fallback-global, irreversible, slot-exhausted,
# validate, no-carry}) — the churn harness's per-reason full-solve breakdown
SOLVER_DELTA_REJECT_TOTAL = "karpenter_solver_delta_reject_total"
# why a multi-group pod shape stayed a count=1 item instead of merging
# (signature compression switched off for it); reason is the bounded
# scheduler_model_grouped.DEMOTION_REASONS enum ({multi-key,
# aff-pin-conflict, hatch-off}) — the LRA regime's compression attribution
SOLVER_PACK_ITEM_DEMOTIONS_TOTAL = "karpenter_solver_pack_item_demotions_total"
# pods-per-item compression of the newest full pack (n_pods / n_items):
# ~1.0 means the grouped scan degenerated to per-pod steps
SOLVER_PACK_ITEM_COMPRESSION = "karpenter_solver_pack_item_compression"
SOLVER_ENCODE_SECONDS = "karpenter_solver_encode_seconds"
SOLVER_FFD_MEMO_TOTAL = "karpenter_solver_ffd_memo_total"
SOLVER_FFD_PHASE_SECONDS = "karpenter_solver_ffd_phase_seconds"
# solvetrace surfaces (obs/trace.py): the recompile sentinel, the trace-ring
# eviction counter, and the rolling per-(mode, phase) latency quantiles
SOLVER_RECOMPILE_TOTAL = "karpenter_solver_recompile_total"
SOLVER_TRACE_DROPPED_TOTAL = "karpenter_solver_trace_dropped_total"
SOLVER_SOLVE_QUANTILE_SECONDS = "karpenter_solver_solve_quantile_seconds"
# steady-state churn serving loop (serving/loop.py + the provisioner's
# coalescing batcher): event is the bounded {arrival | departure} enum
SOLVER_CHURN_COALESCED_TOTAL = "karpenter_solver_churn_coalesced_triggers_total"
SOLVER_CHURN_QUEUE_DEPTH = "karpenter_solver_churn_queue_depth"
SOLVER_CHURN_EVENTS_PER_SOLVE = "karpenter_solver_churn_events_per_solve"
SOLVER_CHURN_EVENTS_TOTAL = "karpenter_solver_churn_events_total"
# tensor-native consolidation (the relaxed-LP repack + masked simulations):
# proposer is the bounded {lp | anneal | binary-search | globalpack} enum,
# decision the exact-validation verdict {accept | reject}
SOLVER_CONSOLIDATION_PROPOSALS_TOTAL = "karpenter_solver_consolidation_proposals_total"
SOLVER_CONSOLIDATION_LP_ITERATIONS_TOTAL = "karpenter_solver_consolidation_lp_iterations_total"
SOLVER_CONSOLIDATION_VALIDATION_TOTAL = "karpenter_solver_consolidation_validation_total"
SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR = "karpenter_solver_consolidation_savings_per_hour"
# globalpack (models/globalpack): the joint provisioning + consolidation
# convex solve behind KARPENTER_SOLVER_GLOBALPACK. All label-free or riding
# the bounded proposer enum above — one rounds counter per global solve, the
# iterations spent inside it, and the newest solve's discrete objective
# improvement over the empty delete-set (the two-phase-equivalent base).
SOLVER_GLOBALPACK_ROUNDS_TOTAL = "karpenter_solver_globalpack_rounds_total"
SOLVER_GLOBALPACK_ITERATIONS_TOTAL = "karpenter_solver_globalpack_iterations_total"
SOLVER_GLOBALPACK_OBJECTIVE_IMPROVEMENT = "karpenter_solver_globalpack_objective_improvement"
# fleet front-end (serving/fleet.py): one solver process multiplexing many
# tenant clusters. `tenant` is the BOUNDED fleet label (serving.fleet
# tenant_label: the first registrations keep their sanitized ids, the rest
# collapse to "overflow"); it also rides karpenter_solver_solve_total and
# the churn families so per-tenant serving behavior is attributable from
# one shared registry.
SOLVER_FLEET_RUNNABLE_TENANTS = "karpenter_solver_fleet_runnable_tenants"
# wake episodes split by the bounded `cause` enum (obs.podtrace.WAKE_CAUSES:
# watch-event | batcher-window | poll-floor | rearm) so wake attribution is
# queryable — which seam actually makes tenants runnable in production
SOLVER_FLEET_WAKE_TOTAL = "karpenter_solver_fleet_wake_total"
SOLVER_FLEET_SCHED_WAIT_SECONDS = "karpenter_solver_fleet_sched_wait_seconds"
# podtrace (obs/podtrace.py): the event-lifecycle flight recorder. `stage`
# is the static STAGES tuple (coalesce | sched_wait | prestage | solve |
# decode | e2e), `tenant` the bounded fleet label, `quantile` the
# three-point rolling enum — all bounded by construction.
SOLVER_EVENT_STAGE_QUANTILE_SECONDS = "karpenter_solver_event_stage_quantile_seconds"
SOLVER_EVENT_SLO_BREACH_TOTAL = "karpenter_solver_event_slo_breach_total"
SOLVER_EVENT_TRACE_DROPPED_TOTAL = "karpenter_solver_event_trace_dropped_total"
# wake-to-solve wait: sub-ms when the fleet loop is idle, growing under
# multiplexing pressure — the fairness policy's observable surface
SOLVER_FLEET_SCHED_WAIT_BUCKETS = (0.000_1, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
# racecheck (obs/racecheck.py): lock-contention observability — wait time per
# named serving-stack lock, emitted by the instrumented wrapper under
# KARPENTER_SOLVER_RACECHECK=1. `lock` is the static make_lock call-site enum.
SOLVER_LOCK_WAIT_SECONDS = "karpenter_solver_lock_wait_seconds"
# faultline (serving/faults.py + the recovery layer): failure-domain
# isolation and graceful degradation. `state` is the bounded
# faults.TENANT_STATES enum (healthy | quarantined | probing), `stage` the
# solver.tpu.RECOVERY_STAGES ladder enum (full-reencode | host-ffd), `seam`
# the faults.FAULT_SEAMS injection enum — all closed tuples.
SOLVER_TENANT_STATE = "karpenter_solver_tenant_state"
SOLVER_BREAKER_TRANSITIONS_TOTAL = "karpenter_solver_breaker_transitions_total"
SOLVER_RECOVERY_TOTAL = "karpenter_solver_recovery_total"
SOLVER_FLEET_SHED_TOTAL = "karpenter_solver_fleet_shed_total"
SOLVER_FLEET_WATCHDOG_TOTAL = "karpenter_solver_fleet_watchdog_total"
SOLVER_FLEET_OLDEST_EVENT_AGE = "karpenter_solver_fleet_oldest_event_age_seconds"
SOLVER_FAULT_INJECTIONS_TOTAL = "karpenter_solver_fault_injections_total"
SOLVER_PRESTAGE_WORKER_RESTARTS_TOTAL = "karpenter_solver_prestage_worker_restarts_total"
SOLVER_WATCH_RESYNC_TOTAL = "karpenter_solver_watch_resync_total"
# shardfleet (serving/shard.py): the multi-process fleet router. `shard` is
# the BOUNDED shard label (serving.shard.shard_label — same cap/overflow
# contract as tenant_label); `state` reuses the faults.TENANT_STATES enum
# for the router's per-shard circuit breakers. The router also re-exposes
# every shard's karpenter_solver_fleet_* samples with an injected `shard`
# label via ShardRouter.merged_metrics.
SOLVER_FLEET_SHARDS = "karpenter_solver_fleet_shards"
SOLVER_SHARD_STATE = "karpenter_solver_shard_state"
SOLVER_SHARD_REHOMED_TOTAL = "karpenter_solver_shard_rehomed_tenants_total"
SOLVER_SHARD_RESTARTS_TOTAL = "karpenter_solver_shard_restarts_total"
# lock waits live well under the solve buckets: sub-ms is the norm, anything
# past 100ms is contention worth a dashboard line. Shared with the wrapper's
# emission site so a registry that skipped make_registry still gets the
# 10µs-resolution series, not DEFAULT_BUCKETS.
SOLVER_LOCK_WAIT_BUCKETS = (0.000_01, 0.000_1, 0.001, 0.01, 0.1, 1.0)


def make_registry() -> Registry:
    """A registry pre-populated with the reference's metric families."""
    r = Registry()
    r.counter(NODECLAIMS_CREATED_TOTAL, "Number of nodeclaims created", ("reason", "nodepool", "min_values_relaxed"))
    r.counter(NODECLAIMS_TERMINATED_TOTAL, "Number of nodeclaims terminated", ("nodepool", "capacity_type", "zone"))
    r.counter(NODECLAIMS_DISRUPTED_TOTAL, "Number of nodeclaims disrupted", ("reason", "nodepool", "capacity_type"))
    r.counter(PODS_DISRUPTION_INITIATED_TOTAL, "Pod disruptions initiated", ("reason", "nodepool", "capacity_type"))
    r.counter(NODES_CREATED_TOTAL, "Nodes created", ("nodepool", "zone"))
    r.counter(NODES_TERMINATED_TOTAL, "Nodes terminated", ("nodepool", "zone"))
    r.histogram(SCHEDULER_SCHEDULING_DURATION, "Duration of one scheduling solve", (), DURATION_BUCKETS)
    r.gauge(SCHEDULER_QUEUE_DEPTH, "Pods waiting in the scheduling queue", ())
    r.gauge(SCHEDULER_UNFINISHED_WORK, "Seconds the in-flight solve has been running", ())
    r.gauge(SCHEDULER_IGNORED_PODS, "Pods ignored by the scheduler", ())
    r.gauge(SCHEDULER_UNSCHEDULABLE_PODS, "Pods the last solve could not place", ())
    r.gauge(
        SCHEDULER_PENDING_PODS_BY_EFFECTIVE_ZONE,
        "Pending pods by effective zone constraint (a zone name, 'flexible', or 'none')",
        ("zone",),
    )
    r.counter(DISRUPTION_DECISIONS_TOTAL, "Disruption decisions", ("decision", "method", "consolidation_type"))
    r.gauge(DISRUPTION_ELIGIBLE_NODES, "Nodes eligible for disruption", ("method", "consolidation_type"))
    r.counter(DISRUPTION_CONSOLIDATION_TIMEOUTS_TOTAL, "Consolidation probes aborted on timeout", ("consolidation_type",))
    r.counter(DISRUPTION_FAILED_VALIDATIONS_TOTAL, "Commands dropped by the validator", ("method",))
    r.counter(DISRUPTION_QUEUE_FAILURES_TOTAL, "Disruption commands that failed in the queue", ("method",))
    r.histogram(DISRUPTION_DECISION_EVAL_DURATION, "Time to compute a disruption decision", ("method",), DURATION_BUCKETS)
    r.gauge(NODEPOOL_ALLOWED_DISRUPTIONS, "Budget-allowed disruptions", ("nodepool", "reason"))
    r.histogram(PODS_STARTUP_DURATION, "Pod creation to running", (), DURATION_BUCKETS)
    r.histogram(PODS_BOUND_DURATION, "Pod creation to bound", (), DURATION_BUCKETS)
    r.gauge(PODS_UNBOUND_TIME, "Seconds a pod has been unbound", ("name", "namespace"))
    r.histogram(PODS_PROVISIONING_BOUND_DURATION, "Karpenter-provisioned pod creation to bound", (), DURATION_BUCKETS)
    r.gauge(PODS_STATE, "Pod state", ("name", "namespace", "phase"))
    r.gauge(NODES_ALLOCATABLE, "Node allocatable by resource", ("node_name", "nodepool", "resource_type", "zone"))
    r.gauge(NODES_TOTAL_POD_REQUESTS, "Pod requests on node", ("node_name", "nodepool", "resource_type"))
    r.gauge(NODES_TOTAL_DAEMON_REQUESTS, "Daemon requests on node", ("node_name", "nodepool", "resource_type"))
    r.gauge(NODES_UTILIZATION, "Requested/allocatable percent", ("node_name", "nodepool", "resource_type"))
    r.gauge(NODES_CURRENT_LIFETIME, "Node age", ("node_name", "nodepool"))
    r.gauge(NODEPOOL_USAGE, "Per-pool resource usage", ("nodepool", "resource_type"))
    r.gauge(NODEPOOL_LIMIT, "Per-pool resource limits", ("nodepool", "resource_type"))
    r.gauge(NODEPOOL_COST_TOTAL, "Total tracked cost of the nodepool (not authoritative for billing)", ("nodepool",))
    r.counter(NODEPOOL_COST_TRACKER_ERRORS_TOTAL, "Cost tracking errors", ("nodepool",))
    r.gauge(CLUSTER_STATE_SYNCED, "1 if cluster state is synced", ())
    r.gauge(CLUSTER_STATE_NODE_COUNT, "Nodes tracked by cluster state", ())
    r.counter(SOLVER_SOLVE_TOTAL, "Solves by backend actually used", ("backend", "tenant"))
    r.counter(SOLVER_FALLBACK_TOTAL, "Tensor-path solves that fell back to the host FFD", ("reason",))
    r.counter(SOLVER_VALIDATION_FAILURES_TOTAL, "Device placements rejected by the post-solve validator", ())
    r.counter(
        SOLVER_HYBRID_RESIDUAL_TOTAL,
        "Hybrid partitioned solves that routed a pod-local residual to the host FFD, by reason family",
        ("reason",),
    )
    r.counter(
        SOLVER_DECODE_REPAIR_TOTAL,
        "Tensor decodes that routed part of the placement through the bounded host repair, by reason family",
        ("reason",),
    )
    r.counter(
        SOLVER_DELTA_REJECT_TOTAL,
        "Delta-capable solves routed to the full path, by reject reason",
        ("reason",),
    )
    r.counter(
        SOLVER_DECODE_TOTAL,
        "Tensor decodes by materialization mode (full | delta-reuse)",
        ("mode",),
    )
    r.counter(
        SOLVER_DECODE_REUSED_SLOTS_TOTAL,
        "Slots served from the decode-delta memo instead of re-materialized",
        (),
    )
    r.counter(
        SOLVER_PACK_ITEM_DEMOTIONS_TOTAL,
        "Pods whose multi-group shape stayed a count=1 pack item instead of "
        "merging, by bounded demotion reason (multi-key | aff-pin-conflict | "
        "hatch-off)",
        ("reason",),
    )
    r.gauge(
        SOLVER_PACK_ITEM_COMPRESSION,
        "Pods-per-item compression of the newest full grouped pack "
        "(n_pods / n_items; ~1.0 = the scan degenerated to per-pod steps)",
        (),
    )
    # backend label values for SOLVER_SOLVE_TOTAL include "hybrid-delta":
    # a warm hybrid re-solve that re-packed only the pod delta against the
    # retained masked carry
    r.histogram(
        SOLVER_ENCODE_SECONDS,
        "Host-side snapshot-encode duration, by mode (full | masked sub-encode | pod delta)",
        ("mode",),
    )
    r.counter(
        SOLVER_FFD_MEMO_TOTAL,
        "Signature-batched host-FFD fit-memo probes, by outcome (hit | miss | invalidate)",
        ("kind",),
    )
    r.histogram(
        SOLVER_FFD_PHASE_SECONDS,
        "Host-FFD per-solve scan time, by phase (existing | inflight | new_claim)",
        ("phase",),
        DURATION_BUCKETS,
    )
    r.counter(
        SOLVER_RECOMPILE_TOTAL,
        "JIT recompiles observed by the solvetrace sentinel, by jitted entry point "
        "(the churn loop's zero-steady-state-recompiles target reads this)",
        ("fn",),
    )
    r.counter(SOLVER_TRACE_DROPPED_TOTAL, "SolveTraces evicted from the bounded flight-recorder ring", ())
    r.gauge(
        SOLVER_SOLVE_QUANTILE_SECONDS,
        "Rolling solve-latency quantiles (p50 | p90 | p99) over the trace ring, per (mode, phase)",
        ("mode", "phase", "quantile"),
    )
    r.counter(
        SOLVER_CHURN_COALESCED_TOTAL,
        "Provisioner triggers that arrived during an in-flight solve and were "
        "coalesced into one batched follow-up solve instead of one solve each",
        ("tenant",),
    )
    r.gauge(
        SOLVER_CHURN_QUEUE_DEPTH,
        "Triggers accumulated in the batcher's pending generation after the last solve",
        ("tenant",),
    )
    r.histogram(
        SOLVER_CHURN_EVENTS_PER_SOLVE,
        "Trigger events drained by one provisioning solve (the coalescing ratio)",
        ("tenant",),
        (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
    )
    r.counter(
        SOLVER_CHURN_EVENTS_TOTAL,
        "Pod churn events applied by the serving loop, by kind (arrival | departure)",
        ("event", "tenant"),
    )
    r.gauge(
        SOLVER_FLEET_RUNNABLE_TENANTS,
        "Tenants currently marked runnable by the fleet front-end's push wake",
        (),
    )
    r.counter(
        SOLVER_FLEET_WAKE_TOTAL,
        "Fleet wake episodes: what marked the tenant runnable and woke the "
        "fleet loop, by bounded cause (watch-event | batcher-window | "
        "poll-floor | rearm)",
        ("tenant", "cause"),
    )
    r.gauge(
        SOLVER_EVENT_STAGE_QUANTILE_SECONDS,
        "Rolling event-lifecycle latency quantiles (p50 | p90 | p99) over the "
        "podtrace ring, per (tenant, stage) — e2e is event-to-placement",
        ("tenant", "stage", "quantile"),
    )
    r.counter(
        SOLVER_EVENT_SLO_BREACH_TOTAL,
        "Completed events whose e2e latency exceeded the podtrace SLO target "
        "(KARPENTER_PODTRACE_SLO) — the SLO budget burn counter",
        ("tenant",),
    )
    r.counter(
        SOLVER_EVENT_TRACE_DROPPED_TOTAL,
        "EventRecords evicted from the bounded podtrace ring or refused at the in-flight cap",
        (),
    )
    r.histogram(
        SOLVER_FLEET_SCHED_WAIT_SECONDS,
        "Time from a tenant becoming runnable to its solve starting (the "
        "deficit-round-robin scheduling delay under multiplexing)",
        ("tenant",),
        SOLVER_FLEET_SCHED_WAIT_BUCKETS,
    )
    r.counter(
        SOLVER_CONSOLIDATION_PROPOSALS_TOTAL,
        "Candidate delete-sets proposed per consolidation round, by proposer "
        "(lp | anneal | binary-search | globalpack)",
        ("proposer",),
    )
    r.counter(
        SOLVER_GLOBALPACK_ROUNDS_TOTAL,
        "Joint provisioning+consolidation global repack solves run",
        (),
    )
    r.counter(
        SOLVER_GLOBALPACK_ITERATIONS_TOTAL,
        "Projected-gradient iterations spent by the global repack (inits x steps per solve)",
        (),
    )
    r.gauge(
        SOLVER_GLOBALPACK_OBJECTIVE_IMPROVEMENT,
        "Newest global solve's discrete objective improvement over the empty delete-set base",
        (),
    )
    r.counter(
        SOLVER_CONSOLIDATION_LP_ITERATIONS_TOTAL,
        "Projected-gradient iterations spent by the relaxed-LP repack (inits x steps per solve)",
        (),
    )
    r.counter(
        SOLVER_CONSOLIDATION_VALIDATION_TOTAL,
        "Exact host validations of device-proposed consolidation subsets, by decision",
        ("decision",),
    )
    r.gauge(
        SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR,
        "Hourly price saved by the newest accepted consolidation command, by proposer",
        ("proposer",),
    )
    r.histogram(
        SOLVER_LOCK_WAIT_SECONDS,
        "Time spent waiting to acquire a named serving-stack lock (racecheck wrapper)",
        ("lock",),
        SOLVER_LOCK_WAIT_BUCKETS,
    )
    r.gauge(
        SOLVER_TENANT_STATE,
        "Per-tenant circuit-breaker state (1 on the current state's series): "
        "healthy | quarantined | probing",
        ("tenant", "state"),
    )
    r.counter(
        SOLVER_BREAKER_TRANSITIONS_TOTAL,
        "Tenant circuit-breaker transitions INTO a state (quarantined = the "
        "failure domain closed; probing = a half-open re-admission probe; "
        "healthy = re-admitted)",
        ("tenant", "state"),
    )
    r.counter(
        SOLVER_RECOVERY_TOTAL,
        "Solve-failure recovery-ladder steps taken, by stage (full-reencode = "
        "quarantined caches + from-scratch retry; host-ffd = exact host fallback)",
        ("stage",),
    )
    r.counter(
        SOLVER_FLEET_SHED_TOTAL,
        "Watch triggers shed by the fleet's per-tenant overload protection "
        "(the tenant's backlog exceeded its cap; its pending pods are served "
        "later, everyone else on time)",
        ("tenant",),
    )
    r.counter(
        SOLVER_FLEET_WATCHDOG_TOTAL,
        "Oldest-event-age watchdog firings: a shedding tenant's backlog aged "
        "past the watchdog bound and was force-served",
        ("tenant",),
    )
    r.gauge(
        SOLVER_FLEET_OLDEST_EVENT_AGE,
        "Age of each runnable tenant's oldest un-served wake (the DRR "
        "starvation surface the watchdog bounds)",
        ("tenant",),
    )
    r.counter(
        SOLVER_FAULT_INJECTIONS_TOTAL,
        "Deterministic faults injected by the faultline FaultSpec plan, by seam",
        ("seam",),
    )
    r.counter(
        SOLVER_PRESTAGE_WORKER_RESTARTS_TOTAL,
        "PendingPrestager worker threads restarted by the serving loop's "
        "supervisor after a (real or injected) death",
        (),
    )
    r.counter(
        SOLVER_WATCH_RESYNC_TOTAL,
        "Level-triggered Cluster resyncs from store content after the watch "
        "stream's gap tracker detected lost Pod events",
        (),
    )
    r.gauge(SOLVER_FLEET_SHARDS, "Shard worker processes currently seated on the router's ring", ())
    r.gauge(
        SOLVER_SHARD_STATE,
        "Per-shard router circuit-breaker state (1 on the current state's "
        "series): healthy | quarantined | probing",
        ("shard", "state"),
    )
    r.counter(
        SOLVER_SHARD_REHOMED_TOTAL,
        "Tenants re-homed onto a shard after their home shard died (recorded-"
        "log replay, bit-identical placement contract)",
        ("shard",),
    )
    r.counter(
        SOLVER_SHARD_RESTARTS_TOTAL,
        "Shard worker processes respawned by the router after a death",
        ("shard",),
    )
    return r


__all__ = [
    "Registry",
    "Counter",
    "Gauge",
    "Histogram",
    "make_registry",
    "DEFAULT_BUCKETS",
    "DURATION_BUCKETS",
]
