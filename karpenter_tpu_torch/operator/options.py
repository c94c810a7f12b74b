"""Global options + feature gates (reference: pkg/operator/options/options.go:68-135).

Flag/env parsing collapses to a dataclass; controllers receive it explicitly
instead of via context injection. The port keeps the dataclasses and their
validation; the reference's `from_env` / `from_args` parsing comes with the
operator runtime that calls it.

`solver_backend` is "ffd" or "gpu", and defaults to "gpu": the port's
provisioner solves with `GPUSolver()` by default, and multi-node
consolidation proposes on the device only when the backend is "gpu" (the
reference's "tpu", which it does not default to).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FeatureGates:
    node_repair: bool = False
    reserved_capacity: bool = True
    spot_to_spot_consolidation: bool = False
    node_overlay: bool = False
    static_capacity: bool = False
    capacity_buffer: bool = False
    dynamic_resources: bool = False


@dataclass
class Options:
    # scheduler knobs (options.go:85-91)
    batch_max_duration: float = 10.0
    batch_idle_duration: float = 1.0
    preference_policy: str = "Respect"  # Respect | Ignore
    min_values_policy: str = "Strict"  # Strict | BestEffort
    solver_backend: str = "gpu"  # ffd | gpu (the Solver plugin point)
    feature_gates: FeatureGates = field(default_factory=FeatureGates)

    # operational surface (options.go:69-84)
    service_name: str = ""
    metrics_port: int = 8080
    health_probe_port: int = 8081
    kube_client_qps: int = 200
    kube_client_burst: int = 300
    enable_profiling: bool = False
    disable_controller_warmup: bool = True
    disable_leader_election: bool = False
    disable_cluster_state_observability: bool = False
    leader_election_name: str = "karpenter-leader-election"
    leader_election_namespace: str = ""
    memory_limit: int = -1  # bytes; <0 = unset
    cpu_requests: int = 1000  # millicores; drives solver/provisioner fan-out
    log_level: str = "info"  # debug | info | error
    log_output_paths: str = "stdout"
    log_error_output_paths: str = "stderr"
    # NOTE mirrors the reference's transitional flag (removed once DRA is GA)
    ignore_dra_requests: bool = True

    def validate(self) -> list[str]:
        """Misconfigurations fail closed with messages (options.go Parse)."""
        errs = []
        if self.preference_policy not in ("Respect", "Ignore"):
            errs.append(f"preference-policy must be Respect or Ignore, got {self.preference_policy!r}")
        if self.min_values_policy not in ("Strict", "BestEffort"):
            errs.append(f"min-values-policy must be Strict or BestEffort, got {self.min_values_policy!r}")
        if self.log_level not in ("debug", "info", "error"):
            errs.append(f"log-level must be debug, info or error, got {self.log_level!r}")
        if self.solver_backend not in ("ffd", "gpu"):
            errs.append(f"solver-backend must be ffd or gpu, got {self.solver_backend!r}")
        if self.batch_idle_duration < 0 or self.batch_max_duration < 0:
            errs.append("batch windows must be non-negative")
        for name, port in (("metrics-port", self.metrics_port), ("health-probe-port", self.health_probe_port)):
            if not 0 <= port <= 65535:
                errs.append(f"{name} must be 0-65535, got {port}")
        return errs
