"""solverlint configuration for the port: `[tool.solverlint-torch]` in
pyproject.toml, when that table exists.

Defaults below ARE the port's configuration; entries of that table override
them key-by-key (kebab-case keys map to the dataclass fields).
`[tool.solverlint-torch]` belongs to the JAX package's own linter and names its
paths, so it is never read here. The shared-field registry is extracted from
`solver/encode.py` by AST — the analyzer never imports solver code, so the
gate stays torch-free and fast.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path


class ConfigError(RuntimeError):
    """Configuration or registry extraction failed: the gate must fail
    loudly rather than pass vacuously."""


@dataclasses.dataclass
class Config:
    # modules on the tensor hot path: shared-array / host-sync / pod-loop
    # rules run only here
    tensor_modules: tuple[str, ...] = (
        "karpenter_tpu_torch/solver/encode.py",
        "karpenter_tpu_torch/solver/gpu.py",
        "karpenter_tpu_torch/solver/check.py",
        # the decode/validate tail rides the same hot path: the consolidation
        # round's masked-sim probes and the LP/global rounding ladder are
        # per-round host work the pod-loop/host-sync rules must see
        "karpenter_tpu_torch/solver/simulate.py",
        "karpenter_tpu_torch/solver/consolidation.py",
        # the port's own stages of the same path: the copy into the device
        # path's problem, the host carry edits, the kernel wrappers and the
        # CPU arm's shard exchange
        "karpenter_tpu_torch/solver/encoded.py",
        "karpenter_tpu_torch/solver/carry.py",
        "karpenter_tpu_torch/kernels/*.py",
        "karpenter_tpu_torch/models/shard_exchange.py",
    )
    # "<file>:<constant>" — the frozenset of EncodedSnapshot field names that
    # derived encodes share by reference
    shared_field_registry: str = "karpenter_tpu_torch/solver/encode.py:SHARED_ENCODE_FIELDS"
    # the fallback-family registry module (reason-family-tiers rule)
    fallback_module: str = "karpenter_tpu_torch/solver/fallback.py"
    # metric-label-cardinality scans every package module
    metrics_modules: tuple[str, ...] = ("karpenter_tpu_torch/**/*.py",)
    # identifiers that mark an iterable as pod/offering-scaled (exact match
    # against bare names and attribute tails)
    pod_axis_names: tuple[str, ...] = ("pods", "n_pods")
    # callees whose results live on device: coercing them is a host sync.
    # fnmatch patterns over the dotted callee (and its last segment).
    device_producers: tuple[str, ...] = (
        # the trailing * also covers greedy_pack_grouped_sharded_state — the
        # meshed pack's carry-state variant returns device tensors just the same
        "greedy_pack_grouped_sharded*",
        "greedy_pack_grouped_compressed",
        "greedy_pack_delta_compressed",
        "greedy_pack_compressed_sharded",
        "greedy_pack_grouped",
        "greedy_pack",
        "recredit_removals",
        "make_tensors",
        "make_item_tensors",
        "make_pod_tensors",
        "lp_repack",
        "global_repack",
        "anneal_chains",
        # the kernel wrappers (kernels/*.py, parallel/sharded.py): each returns
        # the tensors its kernel wrote on the device
        "feasibility",
        "sharded_feasibility",
        "compat_and_key",
        "sharded_compat_matrix",
        "pack_scan",
        "pack_scan_sharded",
        "pack_scan_sharded_grid",
        "pack_scan_sharded_cluster",
        "flat_outputs",
        "recredit",
        "globalpack",
        "score_subsets*",
        "anneal",
        "anneal_prepass",
        "anneal_sharded",
        "perpod_pack",
        # torch's own tensor producers (torch.as_tensor(..., device=...),
        # torch.zeros, ...)
        "torch.*",
    )
    # label keys that must be statically enumerable at counter/histogram
    # call sites (identity labels like nodepool/node_name are exempt).
    # "fn" (recompile sentinel) and "quantile" (rolling trace stats) are the
    # solvetrace label keys; "proposer" is the consolidation proposer enum
    # (lp | anneal | binary-search); "event" is the churn serving loop's
    # {arrival | departure} enum; "lock" is racecheck's static make_lock
    # call-site enum; "tenant" is the fleet front-end's capped label
    # (serving.fleet.tenant_label collapses past-the-cap registrations to
    # "overflow"); "cause" is the fleet wake-attribution enum
    # (obs.podtrace.WAKE_CAUSES) and "stage" the podtrace event-lifecycle
    # stage enum (obs.podtrace.STAGES); "state" is faultline's breaker-state
    # enum (serving.faults.TENANT_STATES — stage also covers the recovery
    # ladder's RECOVERY_STAGES) and "seam" its FAULT_SEAMS injection enum;
    # "shard" is the shardfleet router's capped label (serving.shard
    # shard_label — same overflow contract as tenant) — all held to the
    # same bound
    bounded_labels: tuple[str, ...] = ("reason", "backend", "mode", "decision", "kind", "phase", "fn", "quantile", "proposer", "event", "lock", "tenant", "cause", "stage", "state", "seam", "shard")
    # callees whose return value is enum-bounded by construction
    # (tenant_label caps distinct outputs at serving.fleet.TENANT_LABEL_CAP;
    # shard_label at serving.shard.SHARD_LABEL_CAP; demotion_label collapses
    # anything outside scheduler_model_grouped.DEMOTION_REASONS to "other")
    bounded_label_producers: tuple[str, ...] = ("reason_family", "_reason_family", "tenant_label", "shard_label", "demotion_label")
    # wrapper methods whose OWN bodies forward **labels to the registry
    metric_wrappers: tuple[str, ...] = ("_count", "_observe")
    # cap on distinct literal values per bounded label key, repo-wide
    max_label_values: int = 16
    # -- racecheck (the concurrency rules) ------------------------------------
    # modules on the THREADED serving path: guarded-field-access, lock-order,
    # thread-escape and bare-thread-primitive run only here (the long-lived
    # threads: prestager worker, churn thread, store watch delivery, operator
    # HTTP server, leader-election renewer — plus everything their callbacks
    # touch under a lock)
    thread_modules: tuple[str, ...] = (
        "karpenter_tpu_torch/serving/*.py",
        "karpenter_tpu_torch/kube/store.py",
        "karpenter_tpu_torch/state/cluster.py",
        "karpenter_tpu_torch/state/informer.py",
        "karpenter_tpu_torch/state/cost.py",
        "karpenter_tpu_torch/state/nodepoolhealth.py",
        "karpenter_tpu_torch/metrics/registry.py",
        "karpenter_tpu_torch/controllers/provisioning/batcher.py",
        "karpenter_tpu_torch/controllers/provisioning/provisioner.py",
        "karpenter_tpu_torch/controllers/nodeclaim/podevents.py",
        "karpenter_tpu_torch/operator/*.py",
        "karpenter_tpu_torch/obs/trace.py",
        "karpenter_tpu_torch/obs/podtrace.py",
        "karpenter_tpu_torch/obs/racecheck.py",
        "karpenter_tpu_torch/events/__init__.py",
        "karpenter_tpu_torch/utils/clock.py",
        "karpenter_tpu_torch/__main__.py",
    )
    # the sanctioned wrapper module: the ONLY place raw threading primitives
    # may be constructed (bare-thread-primitive exempts it)
    racecheck_module: str = "karpenter_tpu_torch/obs/racecheck.py"
    # the per-class guarded-field registry attribute (field -> guarding lock
    # attr), read by guarded-field-access AND obs.racecheck.touch at runtime
    guarded_registry_attr: str = "GUARDED_FIELDS"
    # call-site patterns that construct locks (identifies which self.<attr>
    # assignments in __init__ are locks, for both concurrency rules)
    lock_factories: tuple[str, ...] = ("make_lock", "make_rlock", "*.Lock", "*.RLock", "Lock", "RLock")
    # the thread-shared registry: sanctioned `threading.Thread(target=...)` /
    # `spawn_thread(...)` entry points and store-watch callbacks, matched by
    # fnmatch against the dotted callee, its tail, "EnclosingClass.tail",
    # and the path-qualified "<module relpath>:<name>" forms. Every entry is
    # a REVIEWED seam — its shared state is lock-guarded or provably
    # confined (see the inventory in karpenter_tpu_torch/serving/__init__.py).
    # Generic callback names are path-qualified so a same-named function in
    # some future module is NOT silently sanctioned.
    thread_shared: tuple[str, ...] = (
        "PendingPrestager._run",
        "PendingPrestager._on_event",
        "*.serve_forever",  # stdlib ThreadingHTTPServer worker
        "*.renew_loop",  # LeaderElector renewer (target is a non-self attr)
        # fleet front-end (serving/fleet.py): the DRR serve loop thread and
        # the per-tenant watch->wake callback (runs on watch delivery; marks
        # the tenant runnable under the fleet's leaf locks)
        "FleetFrontend._serve_loop",
        "karpenter_tpu_torch/serving/fleet.py:_on_watch_event",
        "karpenter_tpu_torch/serving/churn.py:_churn_driver",
        # shardfleet (serving/shard.py): the router's per-shard run_all
        # threads (one writer per results key), the breaker-driven
        # health monitor, and the worker-side live env tick loop
        "ShardRouter._drive_shard",
        "ShardRouter._monitor_loop",
        "karpenter_tpu_torch/serving/shard.py:_tick_loop",
        # informer/cost watch callbacks: they only call into the
        # lock-guarded Cluster/ClusterCost/Store surfaces
        "karpenter_tpu_torch/state/informer.py:on_*",
        "karpenter_tpu_torch/state/cost.py:on_*",
        "Cluster.mark_unconsolidated",
        "PodEventsController._on_pod_event",
        "Provisioner.trigger",
    )
    # methods that register a store-watch callback (thread-escape checks the
    # callback operand)
    watch_register_methods: tuple[str, ...] = ("watch",)
    # callee patterns that BLOCK (a solve, a device sync, watch-event
    # delivery): calling one while holding a lock is a lock-order finding
    lock_blocking_calls: tuple[str, ...] = ("*.solve", "solve_prepared", "_drain", "synchronize")
    # method-name tails too generic to resolve cross-class in the lock-order
    # call graph (dict/list/set API names) — skipped to keep the static graph
    # from manufacturing edges out of `self._cache.get(...)`
    lock_call_blacklist: tuple[str, ...] = (
        "get", "set", "add", "pop", "update", "clear", "remove", "insert", "append",
        "extend", "discard", "popleft", "appendleft", "setdefault", "copy", "sort",
        "count", "items", "keys", "values", "reset", "total", "value", "sum", "join",
    )
    # the human-readable thread-and-lock inventory lock-order findings point at
    thread_inventory_doc: str = "karpenter_tpu_torch/serving/__init__.py"
    # -- swallowed-exception (faultline) ---------------------------------------
    # modules the swallowed-exception rule scans: a bare `except Exception:`
    # (or broader) handler must re-raise or RECORD (an events publish / a
    # metrics emission) — a serving stack only degrades gracefully if every
    # absorbed failure leaves a signal. Suppression needs a justified pragma.
    exception_modules: tuple[str, ...] = ("karpenter_tpu_torch/**/*.py",)
    # callee patterns (fnmatch over the dotted callee and its tail) that
    # count as RECORDING the failure inside the handler body
    exception_recorders: tuple[str, ...] = (
        "*.publish",  # events.Recorder
        "*.inc",
        "*.observe",
        "*.record_failure",
        "*._count",
        "*._observe",
        "*.warning",
        "*.error",
        "*.exception",
    )
    # -- detlint (the determinism rules) ---------------------------------------
    # modules on the BIT-IDENTICAL-PLACEMENT path: the unordered-iteration
    # rule runs here (solver encode/decode, the pack models, the serving
    # stack whose replay/re-homing contracts pin placement digests, and the
    # mesh-sharded pack)
    det_modules: tuple[str, ...] = (
        "karpenter_tpu_torch/solver/*.py",
        "karpenter_tpu_torch/models/*.py",
        "karpenter_tpu_torch/serving/*.py",
        "karpenter_tpu_torch/parallel/*.py",
        "karpenter_tpu_torch/kernels/*.py",
    )
    # modules reachable from solve/encode/decode/consolidation entry points:
    # wallclock-and-rng-in-solve-path and env-dependent-branch run here (the
    # obs/tracing seams live outside these globs by design — a trace span's
    # perf_counter is observability, not solve input)
    solve_path_modules: tuple[str, ...] = (
        "karpenter_tpu_torch/solver/*.py",
        "karpenter_tpu_torch/models/*.py",
        "karpenter_tpu_torch/parallel/*.py",
        "karpenter_tpu_torch/kernels/*.py",
        "karpenter_tpu_torch/native/*.py",
        "karpenter_tpu_torch/device.py",
    )
    # the reviewed seeded-RNG registry: callee patterns (fnmatch over the
    # dotted callee and its tail) whose randomness is seed-derived and
    # replay-stable — utils/prng.py's key-passing Threefry (the reference's
    # jax.random, bit for bit) is deterministic by construction, and a
    # torch.Generator seeded with manual_seed is a reviewed seeded stream
    seeded_rng: tuple[str, ...] = (
        "prng.*",
        "prng_key",
        "lp_inits",
        "anneal_streams",
        "chain_streams",
        "torch.Generator",
        "*.manual_seed",
    )
    # float-reduction-order scans the host-side accumulation sites adjacent
    # to the sharded pack and the models' host folds
    float_order_modules: tuple[str, ...] = (
        "karpenter_tpu_torch/parallel/sharded.py",
        "karpenter_tpu_torch/models/*.py",
        "karpenter_tpu_torch/kernels/*.py",
    )
    # canonical-order reduction helpers: a host float accumulation routed
    # through one of these is order-stable by construction (math.fsum is
    # exact; stable_host_sum sorts its operands first)
    canonical_reduce_helpers: tuple[str, ...] = ("fsum", "math.fsum", "stable_host_sum")
    # the registered environment-knob table: every os.environ read in the
    # solve-path modules must name one of these reviewed KARPENTER_* knobs —
    # an unregistered env probe can silently fork behavior between shard
    # workers (env-dependent-branch)
    env_knobs: tuple[str, ...] = (
        "KARPENTER_SOLVER_TYPECHECK",
        "KARPENTER_SOLVER_RACECHECK",
        "KARPENTER_SOLVER_DETCHECK",
        "KARPENTER_SOLVER_COMPILE_CACHE",
        "KARPENTER_SOLVER_MESH",
        "KARPENTER_SOLVER_SHARD_DEVICES",
        "KARPENTER_SOLVER_BUCKET",
        "KARPENTER_SOLVER_MULTIGROUP",
        "KARPENTER_SOLVER_GLOBALPACK",
        "KARPENTER_ENCODE_COLUMNAR",
        # decode-delta escape hatch (gpu._decode re-materializes every slot
        # when off) and the consolidation round's shared-scheduler hatch
        # (simulate.ConsolidationSimulator skips the SchedulerRoundSeed carry
        # when off) — both are exact-reference toggles, placement-identical
        "KARPENTER_SOLVER_FASTDECODE",
        "KARPENTER_SIM_SHARED_SCHED",
    )
    # direct override for tests/self-test; when None the registry file is
    # parsed on first use
    shared_fields: frozenset | None = None

    def resolve_shared_fields(self, root: Path) -> frozenset:
        if self.shared_fields is not None:
            return self.shared_fields
        try:
            rel, _, attr = self.shared_field_registry.partition(":")
            src = (root / rel).read_text()
            tree = ast.parse(src)
        except OSError as e:
            raise ConfigError(f"shared-field registry unreadable: {e}") from e
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(t, ast.Name) and t.id == attr for t in node.targets):
                continue
            names = frozenset(
                c.value for c in ast.walk(node.value) if isinstance(c, ast.Constant) and isinstance(c.value, str)
            )
            if names:
                self.shared_fields = names
                return names
        raise ConfigError(f"shared-field registry {self.shared_field_registry!r} not found or empty")


_KEYMAP = {f.name.replace("_", "-"): f.name for f in dataclasses.fields(Config)}


# the pyproject table the port's linter reads; `[tool.solverlint-torch]` is the JAX
# package's and is never read here
TABLE = "solverlint-torch"


def load_config(root: Path) -> Config:
    """Config from `[tool.solverlint-torch]`, falling back to the baked
    defaults."""
    cfg = Config()
    pyproject = root / "pyproject.toml"
    if not pyproject.exists():
        return cfg
    try:
        import tomllib
    except ModuleNotFoundError:  # py310: same API under its backport name
        import tomli as tomllib

    try:
        table = tomllib.loads(pyproject.read_text()).get("tool", {}).get(TABLE, {})
    except tomllib.TOMLDecodeError as e:
        raise ConfigError(f"pyproject.toml unparseable: {e}") from e
    for key, value in table.items():
        field = _KEYMAP.get(key)
        if field is None:
            raise ConfigError(f"[tool.{TABLE}] unknown key {key!r}")
        default = getattr(cfg, field)
        # type-check against the default so a mistyped entry is a loud
        # ConfigError (exit 2), not a mid-run TypeError read as "findings"
        if isinstance(default, tuple):
            if not isinstance(value, list) or not all(isinstance(v, str) for v in value):
                raise ConfigError(f"[tool.{TABLE}] {key} must be a list of strings")
            value = tuple(value)
        elif not isinstance(value, type(default)) or isinstance(value, bool) != isinstance(default, bool):
            raise ConfigError(f"[tool.{TABLE}] {key} must be {type(default).__name__}, got {type(value).__name__}")
        setattr(cfg, field, value)
    return cfg
