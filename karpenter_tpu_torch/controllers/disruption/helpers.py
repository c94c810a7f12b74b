"""Disruption helpers: scheduling simulation and budget mapping
(reference: disruption/helpers.go:53-313)."""

from __future__ import annotations

from ...utils import pods as pod_utils


def simulate_scheduling(provisioner, cluster, candidates: list, clock, reuse=None, sched_seed=None):
    """Clone state minus the candidates, add their reschedulable pods to the
    pending set, and Solve (helpers.go:53-154). The Solver plugin (FFD or GPU)
    is reused for free — the simulation IS a solve on a modified snapshot.

    `reuse` (a solver.simulate.ConsolidationSimulator) serves the probe as a
    masked sub-encode of its round-base encode when the batch sits inside the
    simulator's correctness envelope — placement-identical, at a fraction of
    the per-probe host cost — and falls back to this from-scratch path
    otherwise. `sched_seed` (a scheduling.SchedulerRoundSeed) rides the probe
    snapshot so a from-scratch host build within the round reuses the
    probe-invariant fit-memo/PodData layers. The 15s command Validator never
    passes either: executed commands always re-validate against a fully
    independent from-scratch simulation."""
    if reuse is not None:
        return reuse.simulate(candidates)
    candidate_names = {c.name() for c in candidates}
    all_nodes = cluster.nodes_view()
    state_nodes = [
        n
        for n in all_nodes
        if n.name() not in candidate_names and not n.marked_for_deletion and not n.deleted()
    ]
    pending = provisioner.get_pending_pods()
    deleting_pods = []
    for n in all_nodes:
        if (n.marked_for_deletion or n.deleted()) and n.name() not in candidate_names:
            for key in n.pod_requests:
                ns, name = key.split("/", 1)
                pod = provisioner.store.try_get("Pod", name, ns)
                if pod is not None and pod_utils.is_reschedulable(pod):
                    deleting_pods.append(pod)
    reschedulable = [p for c in candidates for p in c.reschedulable_pods]
    pods = pending + deleting_pods + reschedulable
    snapshot = provisioner.make_snapshot(pods, state_nodes=state_nodes)
    snapshot.enforce_consolidate_after = True
    snapshot.deleting_node_names = candidate_names
    # consolidation must not fall back into reserved capacity it failed to
    # reserve (consolidation.go:45 DisableReservedCapacityFallback)
    snapshot.reserved_offering_mode = "strict"
    snapshot.collect_zone_metrics = False
    if sched_seed is not None:
        snapshot.sched_seed = sched_seed
    results = provisioner.solver.solve(snapshot)
    # prune claims that ended up empty
    results.new_node_claims = [nc for nc in results.new_node_claims if nc.pods]
    return results


def all_non_pending_scheduled(results, candidates) -> bool:
    """Every candidate pod must have found a home; pods that were already
    pending before the simulation don't block (helpers.go AllNonPendingPodsScheduled)."""
    candidate_pod_keys = {p.key() for c in candidates for p in c.reschedulable_pods}
    return not any(k in candidate_pod_keys for k in results.pod_errors)


def build_disruption_budget_mapping(store, cluster, clock, reason: str) -> dict[str, int]:
    """Per-pool allowed disruptions minus nodes already disrupting
    (helpers.go:262-313)."""
    mapping: dict[str, int] = {}
    deleting: dict[str, int] = {}
    counts: dict[str, int] = {}
    for n in cluster.nodes_view():
        pool = n.nodepool_name()
        if pool is None:
            continue
        counts[pool] = counts.get(pool, 0) + 1
        if n.marked_for_deletion or n.deleted():
            deleting[pool] = deleting.get(pool, 0) + 1
    for np in store.list("NodePool"):
        name = np.metadata.name
        allowed = np.allowed_disruptions(clock.now(), counts.get(name, 0), reason)
        mapping[name] = max(0, allowed - deleting.get(name, 0))
    return mapping
