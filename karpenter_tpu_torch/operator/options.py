"""Global options + feature gates (reference: pkg/operator/options/options.go:68-135).

Flag/env parsing collapses to a dataclass; controllers receive it explicitly
instead of via context injection. The full operational surface is mirrored —
service/ports, client QPS/burst, profiling, warmup/leader-election toggles,
observability switch, resource hints, log configuration — alongside the
scheduler knobs and the 7 feature gates. `from_env` honors the reference's
environment-variable fallbacks; `from_args` parses the reference's flag names.

`solver_backend` is "ffd" or "gpu", and defaults to "gpu": the operator's
provisioner solves with `GPUSolver()` by default, and multi-node
consolidation proposes on the device only when the backend is "gpu" (the
reference's "tpu", which it does not default to).
"""

from __future__ import annotations

import os
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

    @classmethod
    def from_env(cls) -> "Options":
        o = cls()
        o.batch_max_duration = float(os.environ.get("BATCH_MAX_DURATION", o.batch_max_duration))
        o.batch_idle_duration = float(os.environ.get("BATCH_IDLE_DURATION", o.batch_idle_duration))
        o.preference_policy = os.environ.get("PREFERENCE_POLICY", o.preference_policy)
        o.min_values_policy = os.environ.get("MIN_VALUES_POLICY", o.min_values_policy)
        o.solver_backend = os.environ.get("SOLVER_BACKEND", o.solver_backend)
        o.service_name = os.environ.get("KARPENTER_SERVICE", o.service_name)
        o.metrics_port = _env_int("METRICS_PORT", o.metrics_port)
        o.health_probe_port = _env_int("HEALTH_PROBE_PORT", o.health_probe_port)
        o.kube_client_qps = _env_int("KUBE_CLIENT_QPS", o.kube_client_qps)
        o.kube_client_burst = _env_int("KUBE_CLIENT_BURST", o.kube_client_burst)
        o.enable_profiling = _env_bool("ENABLE_PROFILING", o.enable_profiling)
        o.disable_controller_warmup = _env_bool("DISABLE_CONTROLLER_WARMUP", o.disable_controller_warmup)
        o.disable_leader_election = _env_bool("DISABLE_LEADER_ELECTION", o.disable_leader_election)
        o.disable_cluster_state_observability = _env_bool(
            "DISABLE_CLUSTER_STATE_OBSERVABILITY", o.disable_cluster_state_observability
        )
        o.leader_election_name = os.environ.get("LEADER_ELECTION_NAME", o.leader_election_name)
        o.leader_election_namespace = os.environ.get("LEADER_ELECTION_NAMESPACE", o.leader_election_namespace)
        o.memory_limit = _env_int("MEMORY_LIMIT", o.memory_limit)
        o.cpu_requests = _env_int("CPU_REQUESTS", o.cpu_requests)
        o.log_level = os.environ.get("LOG_LEVEL", o.log_level)
        o.log_output_paths = os.environ.get("LOG_OUTPUT_PATHS", o.log_output_paths)
        o.log_error_output_paths = os.environ.get("LOG_ERROR_OUTPUT_PATHS", o.log_error_output_paths)
        o.ignore_dra_requests = _env_bool("IGNORE_DRA_REQUESTS", o.ignore_dra_requests)
        _apply_gates(o.feature_gates, os.environ.get("FEATURE_GATES", ""))
        return o

    @classmethod
    def from_args(cls, argv: list[str]) -> "Options":
        """Parse the reference's flag names (options.go AddFlags) on top of the
        environment fallbacks; flags win over env, env wins over defaults.
        Bool flags accept Go's bare form (`--enable-profiling`) and explicit
        values; unknown flags FAIL CLOSED with a message, like the
        reference's flag.FlagSet (provider injectables register their flags
        on the same parser in the reference, they don't bypass it)."""
        import argparse

        o = cls.from_env()
        # Go's flag package accepts single-dash flags; normalize to two
        # (only tokens that look like flags — a negative value such as
        # `--memory-limit -100` must pass through untouched, as Go's flag
        # package accepts the space-separated form)
        argv = [
            "-" + a if a.startswith("-") and not a.startswith("--") and len(a) > 2 and a[1].isalpha() else a
            for a in argv
        ]
        parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
        for flag, (attr, conv) in _FLAG_TABLE.items():
            if conv is _parse_bool:
                # Go flag semantics: bare --flag means true
                parser.add_argument("--" + flag, nargs="?", const="true", default=None)
            else:
                parser.add_argument("--" + flag, default=None)
        parser.add_argument("--feature-gates", default=None)
        ns, unknown = parser.parse_known_args(argv)
        # fail closed on any stray dash token (including `-100` whose flag was
        # forgotten — Go errors with 'flag provided but not defined')
        bad = [a for a in unknown if a.startswith("-")]
        if bad:
            raise ValueError(f"unknown flags: {', '.join(bad)}")
        for flag, (attr, conv) in _FLAG_TABLE.items():
            value = getattr(ns, flag.replace("-", "_"))
            if value is None:
                continue
            try:
                setattr(o, attr, conv(value))
            except ValueError as e:
                raise ValueError(f"--{flag}: {e}") from None
        if ns.feature_gates is not None:
            _apply_gates(o.feature_gates, ns.feature_gates)
        errs = o.validate()
        if errs:
            raise ValueError("; ".join(errs))
        return o


_TRUE_WORDS = {"1", "t", "true"}
_FALSE_WORDS = {"0", "f", "false"}


def _env_bool(name: str, default: bool) -> bool:
    """Go strconv.ParseBool semantics, failing closed with the variable name
    on anything else."""
    v = os.environ.get(name)
    if v is None:
        return default
    lv = v.strip().lower()
    if lv in _TRUE_WORDS:
        return True
    if lv in _FALSE_WORDS:
        return False
    raise ValueError(f"{name}={v!r} is not a valid boolean")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not a valid integer") from None


def _parse_bool(v: str) -> bool:
    """Go strconv.ParseBool forms (1/t/true, 0/f/false)."""
    lv = v.strip().lower()
    if lv in _TRUE_WORDS:
        return True
    if lv in _FALSE_WORDS:
        return False
    raise ValueError(f"{v!r} is not a valid value, must be a boolean")


def _parse_seconds(v: str) -> float:
    """Accept Go-style durations ('10s', '1m') or plain seconds."""
    from ..utils.durations import parse_duration

    try:
        return float(v)
    except ValueError:
        return parse_duration(v)


def _apply_gates(gates: FeatureGates, spec: str) -> None:
    for item in spec.split(","):
        if "=" in item:
            k, v = item.split("=", 1)
            key = k.strip().replace("-", "_")
            snake = "".join("_" + c.lower() if c.isupper() else c for c in key).lstrip("_")
            if hasattr(gates, snake):
                setattr(gates, snake, v.strip().lower() == "true")


_FLAG_TABLE = {
    "karpenter-service": ("service_name", str),
    "metrics-port": ("metrics_port", int),
    "health-probe-port": ("health_probe_port", int),
    "kube-client-qps": ("kube_client_qps", int),
    "kube-client-burst": ("kube_client_burst", int),
    "enable-profiling": ("enable_profiling", _parse_bool),
    "disable-controller-warmup": ("disable_controller_warmup", _parse_bool),
    "disable-leader-election": ("disable_leader_election", _parse_bool),
    "disable-cluster-state-observability": ("disable_cluster_state_observability", _parse_bool),
    "leader-election-name": ("leader_election_name", str),
    "leader-election-namespace": ("leader_election_namespace", str),
    "memory-limit": ("memory_limit", int),
    "cpu-requests": ("cpu_requests", int),
    "log-level": ("log_level", str),
    "log-output-paths": ("log_output_paths", str),
    "log-error-output-paths": ("log_error_output_paths", str),
    "batch-max-duration": ("batch_max_duration", _parse_seconds),
    "batch-idle-duration": ("batch_idle_duration", _parse_seconds),
    "preference-policy": ("preference_policy", str),
    "min-values-policy": ("min_values_policy", str),
    "solver-backend": ("solver_backend", str),
    "ignore-dra-requests": ("ignore_dra_requests", _parse_bool),
}
