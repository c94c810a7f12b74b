"""SolverSnapshot: everything one provisioning solve needs, host-side.

Built by the provisioner from cluster state (the reference's equivalent is the
argument set of NewScheduler, provisioner.go:261-348).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SolverSnapshot:
    store: object
    cluster: object
    node_pools: list
    instance_types: dict  # nodepool name -> [InstanceType]
    state_nodes: list
    daemonset_pods: list
    pods: list
    clock: object
    preference_policy: str = "Respect"
    min_values_policy: str = "Strict"
    enforce_consolidate_after: bool = False
    deleting_node_names: set = field(default_factory=set)
    dra_enabled: bool = False
    reserved_capacity_enabled: bool = True  # ReservedCapacity feature gate
    reserved_offering_mode: str = "fallback"  # strict for consolidation sims
    # skip the effective-zone metric computation (consolidation simulations
    # discard it; scheduler.go computes it only on the provisioner path)
    collect_zone_metrics: bool = True
    # metrics Registry the host scheduler reports into (ffd-memo counters +
    # phase histograms); None disables scheduler-side metric emission
    registry: object = None

    def with_pods(self, pods: list) -> "SolverSnapshot":
        """The same solve context over a different pod set — the hybrid
        partitioned solver's sub-snapshot constructor."""
        import dataclasses

        return dataclasses.replace(self, pods=pods)
