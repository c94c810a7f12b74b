"""Run the reference's operator-level test suites as twins on the port.

Each reference test case runs twice: once as it is, and once as a twin
whose `karpenter_tpu` imports name `karpenter_tpu_torch` (`helpers` becomes
the port's `testing.scenarios`). The twin's `Environment` and `Options`
come from two shim modules:

- `Options` defaults `solver_backend` to "ffd", the reference's default
  (the port's own default is "gpu", held by
  `test_torch_operator.py::test_port_default_backend_is_gpu`);
- `Environment` runs its GPU solver on the CPU (`device="cpu"`) and takes
  those `Options` when it is given none;
- a test that names the reference's "tpu" backend names the port's "gpu",
  and `last_backend == "tpu"` reads the port's name for that arm.

Both runs start from the same module state: pod names counted from 1, uids
from one seeded generator, the `random` stream and the hostname counters
started again, fresh process-wide trace recorders. While a run lasts, every
`Environment.tick()` under a `FakeClock` appends the environment's
canonical state (`env_state`: the store's NodePools, NodeClaims, Nodes and
Pods with each pod's node, the recorder's events and the registry's
samples), and the leader elector's and the option parser's entry points
append what they returned or raised. The two records must be equal and the
reference's assertions must hold in the twin (a case the reference skips
must skip alike). Under the wall clock (`Clock()`) only the assertions are
compared. Tolerance: exact.

Serving's suites (`serving/`) run the same way. The twin's `ChurnHarness`,
`FleetFrontend` and `ShardRouter` default their device to the CPU, and its
`TPUSolver` is `GPUSolver(device="cpu")` under the reference's constructor
(shim modules again); `from test_churn_loop import` and `from test_fleet
import` name those suites' own twins, `from test_solver import
make_snapshot` a builder over the port's classes. Under a `FakeClock`, on
the test's own thread and outside `ChurnHarness.run_concurrent`, a run also
records every serving pump that solved (the solver's mode and the store's
canonical state), every fleet DRR round's served map, the placement digest
after every `ChurnHarness.bind_flush`, the wall-clock-free fields of every
`ChurnReport` and every `repack_savings` value (the exact-validated
command's savings; a global repack plan's raw proposals are not compared:
on a fleet of identical candidates the relaxed solve's fractional deletions
tie to the last bits, where K5's plain version and XLA's order them
differently); always, the digests every shard router's `run_all` and `rehome_tenants`
returned (their workers replay under a `FakeClock`). A module's autouse
fixtures run around each case, its other fixtures are called for the cases
that name them; `tmp_path` is a fresh directory. While a port case runs,
the port's `resolve_device(None)` names the CPU, so a solver, provisioner
or proposer the case builds with no device runs there. A suite that imports
helpers from one of `TWIN_DEPS` (the consolidation suites, the minValues
suite, besides serving's) gets that suite's own twin.

Only the port's twin tests import this module; nothing of it is in the
package.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import functools
import importlib
import itertools
import random
import re
import sys
import tempfile
import threading
import types
import uuid
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"
UID_SEED = 17

OPERATOR_SHIM = "_twin_port_operator"
OPTIONS_SHIM = "_twin_port_operator_options"
SERVING_SHIM = "_twin_port_serving"  # + "_<submodule>" for serving's modules
SOLVER_SHIM = "_twin_port_solver_tpu"
TEST_SOLVER_SHIM = "_twin_port_test_solver"
MODEL_SHIM = "_twin_port_model"
# reference suites whose helpers other suites import: the port's twin of a
# suite imports their port twins
TWIN_DEPS = ("test_churn_loop", "test_fleet", "test_consolidation_tpu", "test_consolidation_lp", "test_minvalues_tensor")
SERVING_MODULES = ("churn", "faults", "fleet", "loop", "prestage", "shard")


# -- the cases ------------------------------------------------------------------------
def _param_ids(fn: ast.FunctionDef) -> list[tuple[str, dict]]:
    """The (id suffix, arguments) of each parametrisation of `fn` (one
    `pytest.mark.parametrize` with literal values at most), or [("", {})]."""
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call) and ast.unparse(dec.func).endswith("mark.parametrize"):
            names = [n.strip() for n in ast.literal_eval(dec.args[0]).split(",")]
            values = ast.literal_eval(dec.args[1])
            out = []
            for v in values:
                v = v if len(names) > 1 else (v,)
                out.append(("[" + "-".join(map(str, v)) + "]", dict(zip(names, v))))
            return out
    return [("", {})]


@functools.lru_cache(maxsize=None)
def _functions(name: str) -> dict[str, ast.FunctionDef]:
    tree = ast.parse((TESTS / f"{name}.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            for f in node.body:
                if isinstance(f, ast.FunctionDef) and f.name.startswith("test_"):
                    out[f"{node.name}.{f.name}"] = f
    return out


def reference_cases(name: str, skip_classes: tuple = (), only_classes: tuple | None = None) -> list[str]:
    """Every test of a reference module as "Class.method[param]" or
    "function[param]", read from its source (so every worker collects the
    same list); with `only_classes`, those classes' tests only."""
    return [case + pid for case, fn in _functions(name).items() if case.split(".")[0] not in skip_classes
            and (only_classes is None or case.split(".")[0] in only_classes)
            for pid, _ in _param_ids(fn)]


def is_slow(name: str, case: str) -> bool:
    """Whether the reference marks the case `slow`."""
    fn = _functions(name)[case.partition("[")[0]]
    return any(ast.unparse(d).endswith("mark.slow") for d in fn.decorator_list)


# -- the twin modules -----------------------------------------------------------------
def port_rewrite(src: str) -> str:
    """A reference test module's source as the port's twin: the operator
    through the shims, the "tpu" backend as "gpu", every other
    `karpenter_tpu` import the port's, `helpers` the port's scenarios."""
    src = src.replace("karpenter_tpu.operator.options import", f"{OPTIONS_SHIM} import")
    src = src.replace("from karpenter_tpu.operator import", f"from {OPERATOR_SHIM} import")
    src = src.replace('solver_backend="tpu"', 'solver_backend="gpu"')
    src = src.replace('last_backend == "tpu"', 'last_backend == "gpu"')
    src = src.replace('backend="tpu", tenant=', 'backend="gpu", tenant=')
    # the compile cache's counterpart (also inside a subprocess's code)
    src = src.replace("karpenter_tpu.solver.tpu import configure_compile_cache",
                      f"{PORT}.solver.gpu import configure_compile_cache")
    src = re.sub(r"^(\s*)from karpenter_tpu\.solver\.tpu import", rf"\1from {SOLVER_SHIM} import", src, flags=re.M)
    src = re.sub(r"^(\s*)from karpenter_tpu\.serving(?:\.(\w+))? import",
                 lambda mt: f"{mt[1]}from {SERVING_SHIM}{'_' + mt[2] if mt[2] else ''} import", src, flags=re.M)
    src = re.sub(r"^(\s*)from karpenter_tpu\.models\.scheduler_model(_grouped)? import (make_tensors|item_pad_targets)$",
                 rf"\1from {MODEL_SHIM} import \3", src, flags=re.M)
    src = re.sub(r"^(\s*)from test_solver import (.*\bmake_snapshot\b.*)$", rf"\1from {TEST_SOLVER_SHIM} import \2",
                 src, flags=re.M)
    src = re.sub(rf"^(\s*)from ({'|'.join(TWIN_DEPS)}) import", rf"\1from _twin_{PORT}_\2 import", src, flags=re.M)
    src = re.sub(r"\bkarpenter_tpu\b", PORT, src)
    return re.sub(r"^(\s*)from helpers import", rf"\1from {PORT}.testing.scenarios import", src, flags=re.M)


def _fixtures(src: str) -> str:
    """Autouse fixtures become functions the twin runs around each case;
    the other fixtures (a class's or a module's, any scope) functions it
    calls for the cases that name them."""
    src = src.replace("@pytest.fixture(autouse=True)\n", "@_twin_autouse\n")
    return re.sub(r"^(\s*)@pytest\.fixture(\(scope=\"(class|module|function)\"\))?\n", r"\1@_twin_fixture\n", src,
                  flags=re.M)


@functools.lru_cache(maxsize=None)
def _twin_code(name: str, pkg: str):
    src = _fixtures((TESTS / f"{name}.py").read_text())
    if pkg == PORT:
        src = port_rewrite(src)
    return compile(src, str(TESTS / f"{name}.py"), "exec")


def install_shims() -> None:
    """The twin's `Options` (default backend "ffd") and `Environment` (its
    GPU solver on the CPU), as importable modules."""
    from karpenter_tpu_torch import operator as port_operator
    from karpenter_tpu_torch.operator import options as port_options

    @dataclasses.dataclass
    class Options(port_options.Options):
        solver_backend: str = "ffd"

    class Environment(port_operator.Environment):
        def __init__(self, options=None, *args, device="cpu", **kwargs):
            super().__init__(options if options is not None else Options(), *args, device=device, **kwargs)

    opts = types.ModuleType(OPTIONS_SHIM)
    opts.__dict__.update({k: v for k, v in vars(port_options).items() if not k.startswith("__")})
    opts.Options = Options
    op = types.ModuleType(OPERATOR_SHIM)
    op.Environment = Environment
    sys.modules[OPTIONS_SHIM], sys.modules[OPERATOR_SHIM] = opts, op
    _install_serving_shims()


def _install_serving_shims() -> None:
    """The twin's serving modules (their entry points on the CPU), its
    `solver.tpu` (the port's solver under the reference's constructor) and
    its `test_solver.make_snapshot`."""
    from karpenter_tpu_torch.solver import gpu as port_gpu

    serving = importlib.import_module(f"{PORT}.serving")

    class ChurnHarness(serving.ChurnHarness):
        def __init__(self, spec=None, device="cpu"):
            super().__init__(spec, device=device)

    class FleetFrontend(serving.FleetFrontend):
        def __init__(self, *args, device="cpu", **kwargs):
            super().__init__(*args, device=device, **kwargs)

    class ShardRouter(serving.ShardRouter):
        def __init__(self, *args, device="cpu", **kwargs):
            super().__init__(*args, device=device, **kwargs)

    cpu = {"ChurnHarness": ChurnHarness, "FleetFrontend": FleetFrontend, "ShardRouter": ShardRouter}
    for sub in ("",) + SERVING_MODULES:
        real = importlib.import_module(f"{PORT}.serving{'.' + sub if sub else ''}")
        shim = types.ModuleType(SERVING_SHIM + ("_" + sub if sub else ""))
        shim.__dict__.update({k: v for k, v in vars(real).items() if not k.startswith("__")})
        shim.__dict__.update({k: v for k, v in cpu.items() if k in vars(real)})
        sys.modules[shim.__name__] = shim

    class TPUSolver(port_gpu.GPUSolver):
        def __init__(self, fallback=None, force=False, registry=None, mesh="auto", hybrid=True, recorder=None,
                     tenant="", recover=True):
            super().__init__(device="cpu", force=force, registry=registry, recorder=recorder, tenant=tenant,
                             recover=recover, mesh=mesh)

    solver = types.ModuleType(SOLVER_SHIM)
    solver.__dict__.update({k: v for k, v in vars(port_gpu).items() if not k.startswith("__")})
    solver.TPUSolver = TPUSolver
    sys.modules[SOLVER_SHIM] = solver

    def make_snapshot(pods, node_pools=None, types=None):
        from karpenter_tpu_torch.apis import labels as wk
        from karpenter_tpu_torch.cloudprovider import catalog
        from karpenter_tpu_torch.kube import Store
        from karpenter_tpu_torch.solver.snapshot import SolverSnapshot
        from karpenter_tpu_torch.state import Cluster
        from karpenter_tpu_torch.state.informer import start_informers
        from karpenter_tpu_torch.testing.scenarios import make_nodepool
        from karpenter_tpu_torch.utils.clock import FakeClock

        linux_amd64 = [{"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
                       {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]}]

        store = Store()
        clock = FakeClock()
        cluster = Cluster(store, clock)
        start_informers(store, cluster)
        node_pools = node_pools or [make_nodepool(requirements=linux_amd64)]
        for np_ in node_pools:
            store.create(np_)
        types = types if types is not None else catalog.construct_instance_types()
        return SolverSnapshot(store=store, cluster=cluster, node_pools=node_pools,
                              instance_types={np_.metadata.name: types for np_ in node_pools},
                              state_nodes=cluster.nodes(), daemonset_pods=[], pods=pods, clock=clock)

    # the reference's pod-axis tensor view for `test_churn_loop`'s pad-target
    # case: the port packs work items, so its counterpart of "a delta's pad
    # targets line up with the resident tensors" holds `item_pad_targets`
    # against the port's own item arrays (res, keys, words and groups from
    # the items, exist and ports from the rows)
    class ModelView:
        def __init__(self, t, items):
            self.t, self.items = t, items
            self.pod_req, self.pod_mask, self.member = items.item_req, items.item_mask, items.item_member
            self.existing_domset, self.row_port_any = t.existing_domset, t.row_port_any

    def view_make_tensors(enc, with_pods=True):
        from karpenter_tpu_torch.models.scheduler_model import make_tensors
        from karpenter_tpu_torch.models.scheduler_model_grouped import build_items, make_item_tensors
        from karpenter_tpu_torch.solver.encoded import from_reference

        problem = from_reference(enc)
        t = make_tensors(problem, torch.device("cpu"))
        return ModelView(t, make_item_tensors(build_items(problem)[0], torch.device("cpu")))

    def view_item_pad_targets(view):
        from karpenter_tpu_torch.models.scheduler_model_grouped import item_pad_targets

        return item_pad_targets(view.t, view.items)

    model = types.ModuleType(MODEL_SHIM)
    model.make_tensors, model.item_pad_targets = view_make_tensors, view_item_pad_targets
    sys.modules[MODEL_SHIM] = model

    from karpenter_tpu_torch.apis import labels as wk

    ts = types.ModuleType(TEST_SOLVER_SHIM)
    ts.make_snapshot = make_snapshot
    ts.LINUX_AMD64 = [{"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
                      {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]}]
    sys.modules[TEST_SOLVER_SHIM] = ts


def _mark_fixture(fn):
    fn._twin_fixture = True
    return fn


@contextlib.contextmanager
def cpu_by_default():
    """While it lasts, the port's `resolve_device(None)` names the CPU, as
    the twin's solvers, provisioners and proposers built with no device run
    there (the serving shims' devices); every binding of the name in the
    port's modules, those imported meanwhile too, is the real one again
    afterwards."""
    dev_mod = importlib.import_module(f"{PORT}.device")
    real = dev_mod.resolve_device

    def on_cpu(device=None):
        return real("cpu" if device is None else device)

    def rebind(old, new):
        for name, mod in list(sys.modules.items()):
            if (name == PORT or name.startswith(PORT + ".")) and mod is not None \
                    and mod.__dict__.get("resolve_device") is old:
                mod.resolve_device = new

    rebind(real, on_cpu)
    try:
        yield
    finally:
        rebind(on_cpu, real)


def load_twin(pkg: str, name: str) -> types.ModuleType:
    """A fresh twin of reference test module `name` for `pkg` (and, for the
    port, fresh twins of the suites it imports helpers from)."""
    if pkg == PORT:
        install_shims()
        src = (TESTS / f"{name}.py").read_text()
        for dep in TWIN_DEPS:
            if dep != name and re.search(rf"^\s*from {dep} import", src, flags=re.M):
                load_twin(pkg, dep)
    mod = types.ModuleType(f"_twin_{pkg}_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    mod._TWIN_AUTOUSE = []
    mod._twin_autouse = lambda fn: mod._TWIN_AUTOUSE.append(fn) or fn
    mod._twin_fixture = _mark_fixture
    sys.modules[mod.__name__] = mod
    exec(_twin_code(name, pkg), mod.__dict__)
    return mod


def same_start(pkg: str) -> None:
    """The module state a twin run starts from."""
    random.seed(0)
    for p in (REF, PORT):
        importlib.import_module(f"{p}.controllers.provisioning.scheduling.nodeclaim")._hostname_seq = itertools.count(1)
        importlib.import_module(f"{p}.scheduling.dynamicresources.cel")._cache.clear()
        trace = importlib.import_module(f"{p}.obs.trace")
        trace._DEFAULT = trace.TraceRecorder()
    if pkg == PORT:
        importlib.import_module(f"{PORT}.testing.scenarios")._seq = itertools.count(1)
    else:
        importlib.import_module("helpers")._seq = itertools.count(1)


@contextlib.contextmanager
def seeded_uids(seed: int = UID_SEED):
    rng = random.Random(seed)
    real = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
    try:
        yield
    finally:
        uuid.uuid4 = real


# -- what a run records -------------------------------------------------------------
def events_view(recorder) -> tuple:
    return tuple((e.involved_kind, e.involved_name, e.type, e.reason, e.message, e.timestamp)
                 for e in recorder.events)


# counted from wall-clock latencies (an event's end-to-end seconds against
# the SLO), or from the race checker's lock acquisitions (which the solver
# behind the provisioner and the threads' timing set), so the runs may differ
NOT_COMPARED = frozenset({"karpenter_solver_event_slo_breach_total", "karpenter_solver_lock_wait_seconds"})


def env_state(env, port: bool) -> tuple:
    """An environment's canonical state: the store (`canonical_store`), the
    events and the registry (`test_torch_metrics.registry_view`: every
    family's samples, histograms by count, wall-time gauges and
    `NOT_COMPARED` left out)."""
    from karpenter_tpu_torch.testing.canonical import canonical_store
    from test_torch_metrics import registry_view

    reg = {k: v for k, v in registry_view(env.registry, port).items() if k not in NOT_COMPARED}
    return canonical_store(env.store), events_view(env.recorder), reg


def _lease(store):
    lease = store.try_get("Lease", "karpenter-leader-election", "kube-system")
    if lease is None:
        return None
    return (lease.holder_identity, lease.lease_transitions, lease.acquire_time, lease.renew_time,
            lease.lease_duration_seconds, lease.metadata.resource_version)


def _options_view(o) -> tuple:
    return tuple(sorted((k, repr(v)) for k, v in dataclasses.asdict(o).items()))


@contextlib.contextmanager
def recording(pkg: str):
    """While it lasts, under a FakeClock: every `Environment.tick()` appends
    (environment index, `env_state`) and `LeaderElector.
    try_acquire_or_renew`, `is_leader` and `release` their return and the
    lease; always: `Options.from_env` / `from_args` the options or the
    error."""
    log: list = []
    envs: dict = {}  # id of each environment ticked -> its index
    saved = []
    port = pkg == PORT
    runtime = importlib.import_module(f"{pkg}.operator.runtime")
    leader = importlib.import_module(f"{pkg}.operator.leaderelection")
    options = importlib.import_module(f"{pkg}.operator.options")

    def patch(owner, attr, make):
        real = owner.__dict__[attr]
        saved.append((owner, attr, real))
        fn = make(real.__func__ if isinstance(real, classmethod) else real)
        setattr(owner, attr, classmethod(fn) if isinstance(real, classmethod) else fn)

    def tick(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            real(self, *args, **kwargs)
            if type(self.clock).__name__ == "FakeClock":
                idx = envs.setdefault(id(self), len(envs))
                log.append(("tick", idx, self.clock.now(), env_state(self, port)))
        return recorded

    def elector(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            if type(self.clock).__name__ == "FakeClock":
                log.append((real.__name__, self.identity, out, _lease(self.store)))
            return out
        return recorded

    def parser(real):
        @functools.wraps(real)
        def recorded(cls, *args, **kwargs):
            try:
                out = real(cls, *args, **kwargs)
            except Exception as e:
                log.append((real.__name__, "raise", type(e).__name__, str(e)))
                raise
            log.append((real.__name__, _options_view(out)))
            return out
        return recorded

    try:
        patch(runtime.Environment, "tick", tick)
        for attr in ("try_acquire_or_renew", "is_leader", "release"):
            patch(leader.LeaderElector, attr, elector)
        for attr in ("from_env", "from_args"):
            patch(options.Options, attr, parser)
        _record_serving(pkg, log, patch)
        yield log
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


def report_view(rep, spec) -> tuple:
    """A ChurnReport's wall-clock-free fields (`testing.serving.
    REPORT_FIELDS`; the prestager's counts only when it stages
    synchronously, the coalesced count only without the concurrent
    segment), dicts by key (a prestager worker's fault may fire before or
    after a watch fault)."""
    from karpenter_tpu_torch.testing.serving import REPORT_FIELDS

    skip = (("prestage_reused", "prestage_staged") if spec.worker else ()) + \
        (("coalesced_triggers",) if spec.concurrent_seconds > 0 else ())
    d = rep.as_dict()
    return tuple((k, tuple(sorted(d[k].items())) if isinstance(d[k], dict) else d[k])
                 for k in REPORT_FIELDS if k not in skip)


def _record_serving(pkg: str, log: list, patch) -> None:
    """The serving records (module docstring)."""
    loop_mod = importlib.import_module(f"{pkg}.serving.loop")
    churn = importlib.import_module(f"{pkg}.serving.churn")
    fleet = importlib.import_module(f"{pkg}.serving.fleet")
    shard = importlib.import_module(f"{pkg}.serving.shard")
    from karpenter_tpu_torch.testing.canonical import canonical_store

    wall = [0]  # > 0 inside a wall-clock segment (run_concurrent)
    main = threading.current_thread()

    def fake(clock) -> bool:
        return type(clock).__name__ == "FakeClock" and not wall[0] and threading.current_thread() is main

    def pump(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            prov = self.provisioner
            if out is not None and fake(prov.clock):
                log.append(("pump", getattr(prov.solver, "last_solve_mode", ""), canonical_store(prov.store)))
            return out
        return recorded

    def fleet_pump(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            if all(fake(s.env.clock) for s in self.sessions().values()):
                log.append(("fleet_pump", tuple(sorted(out.items()))))
            return out
        return recorded

    def bind_flush(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            real(self, *args, **kwargs)
            if fake(self.env.clock):
                log.append(("bind_flush", shard.placement_digest(self.env)))
        return recorded

    def run(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            if fake(self.env.clock):
                log.append(("report", report_view(out, self.spec)))
            return out
        return recorded

    def concurrent(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            wall[0] += 1
            try:
                return real(self, *args, **kwargs)
            finally:
                wall[0] -= 1
        return recorded

    def repack(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            log.append(("repack_savings", args, tuple(sorted(kwargs.items())), round(out, 6)))
            return out
        return recorded

    def digests(real):
        @functools.wraps(real)
        def recorded(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            log.append((real.__name__, tuple(sorted((t, r.get("digest")) for t, r in self._tenants.items())),
                        tuple(sorted(out)) if isinstance(out, dict) else out))
            return out
        return recorded

    patch(loop_mod.ServingLoop, "pump", pump)
    patch(fleet.FleetFrontend, "pump", fleet_pump)
    patch(churn.ChurnHarness, "bind_flush", bind_flush)
    for attr in ("run", "run_replay"):
        patch(churn.ChurnHarness, attr, run)
    patch(churn.ChurnHarness, "run_concurrent", concurrent)
    patch(churn.ChurnHarness, "repack_savings", repack)
    patch(shard.ShardRouter, "run_all", digests)
    patch(shard.ShardRouter, "rehome_tenants", digests)


# reference cases that wait their own fixed wall-clock time (5 s) for a
# fleet serve loop's first solve: in the reference's suite earlier cases have
# compiled the pack for such shapes, so a twin runs them warmed alike (one
# solve of the same spec's stack first, before the module state is reset)
WARM_SERVING = frozenset({("test_podtrace", "TestThreadedFleetPodtrace.test_cross_thread_stamps_under_sanitizer"),
                          ("test_fleet", "TestThreadedFleetRacecheck.test_serve_loop_under_sanitizer_is_clean")})


def warm_serving(pkg: str) -> None:
    serving = importlib.import_module(f"{pkg}.serving")
    spec = serving.ChurnSpec(n_base_pods=0, n_types=12, batch_idle_seconds=0.05, concurrent_seconds=0.0)
    h = serving.ChurnHarness(spec, **({"device": "cpu"} if pkg == PORT else {})).build()
    try:
        h.apply_arrivals(50)
        h.solve(force=True)
    finally:
        h.close()


# -- one case ------------------------------------------------------------------------
def run_case(pkg: str, module: str, case: str) -> tuple:
    """One reference test case run on package `pkg`: (its outcome, the
    record of its calls). The outcome is "passed" or ("skipped", reason);
    a failed assertion raises."""
    base, _, pid = case.partition("[")
    fn_node = _functions(module)[base]
    params = dict(_param_ids(fn_node))["[" + pid if pid else ""]
    owner, _, fn_name = base.rpartition(".")
    if (module, base) in WARM_SERVING:
        warm_serving(pkg)
    same_start(pkg)
    with contextlib.ExitStack() as stack:
        stack.enter_context(seeded_uids())
        log = stack.enter_context(recording(pkg))
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        if pkg == PORT:
            stack.enter_context(cpu_by_default())
        mod = load_twin(pkg, module)
        inst = getattr(mod, owner)() if owner else None
        fn = getattr(inst, fn_name) if owner else getattr(mod, fn_name)
        wanted = [a.arg for a in fn_node.args.args]
        args = dict(params)
        if "monkeypatch" in wanted:
            args["monkeypatch"] = mp
        if "tmp_path" in wanted:
            args["tmp_path"] = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="twin-")))
        for fx in mod._TWIN_AUTOUSE:
            gen = fx()
            next(gen)
            stack.callback(next, gen, None)
        for arg in wanted:
            fixture = getattr(inst if inst is not None and hasattr(inst, arg) else mod, arg, None)
            if arg not in args and getattr(fixture, "_twin_fixture", False):
                args[arg] = fixture()
        try:
            fn(**args)
        except pytest.skip.Exception as e:
            return ("skipped", str(e)), log
    return "passed", log


def assert_twin_case(module: str, case: str) -> None:
    want_outcome, want = run_case(REF, module, case)
    got_outcome, got = run_case(PORT, module, case)
    assert got_outcome == want_outcome, f"{module}::{case}: {got_outcome}, the reference's {want_outcome}"
    assert len(got) == len(want), f"{module}::{case}: {len(got)} records, the reference's {len(want)}"
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{module}::{case}: record {k} ({w[0]}) differs"


def cases_of(modules: tuple) -> list[tuple[str, str]]:
    return [(m, c) for m in modules for c in reference_cases(m)]


def params_of(cases: list[tuple[str, str]]) -> list:
    """pytest parameters for (module, case) pairs: a case the reference
    marks `slow` stays `slow`."""
    return [pytest.param(m, c, id=f"{m}::{c}", marks=(pytest.mark.slow,) if is_slow(m, c) else ())
            for m, c in cases]


def assert_every_case_covered(modules: tuple) -> None:
    """Each test pytest collects from the reference modules is one twin
    case: the source reading and the imported modules agree."""
    for name in modules:
        mod = importlib.import_module(name)
        collected = []
        for attr, obj in vars(mod).items():
            if attr.startswith("test_") and callable(obj):
                collected.append(attr)
            elif attr.startswith("Test") and isinstance(obj, type):
                collected += [f"{attr}.{m}" for m in vars(obj) if m.startswith("test_")]
        read = sorted({c.partition("[")[0] for c in reference_cases(name)})
        assert sorted(collected) == read, name
