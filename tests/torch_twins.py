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


def reference_cases(name: str, skip_classes: tuple = ()) -> list[str]:
    """Every test of a reference module as "Class.method[param]" or
    "function[param]", read from its source (so every worker collects the
    same list)."""
    return [case + pid for case, fn in _functions(name).items() if case.split(".")[0] not in skip_classes
            for pid, _ in _param_ids(fn)]


# -- the twin modules -----------------------------------------------------------------
def port_rewrite(src: str) -> str:
    """A reference test module's source as the port's twin: the operator
    through the shims, the "tpu" backend as "gpu", every other
    `karpenter_tpu` import the port's, `helpers` the port's scenarios."""
    src = src.replace("karpenter_tpu.operator.options import", f"{OPTIONS_SHIM} import")
    src = src.replace("from karpenter_tpu.operator import", f"from {OPERATOR_SHIM} import")
    src = src.replace('solver_backend="tpu"', 'solver_backend="gpu"')
    src = src.replace('last_backend == "tpu"', 'last_backend == "gpu"')
    src = re.sub(r"\bkarpenter_tpu\b", PORT, src)
    return re.sub(r"^from helpers import", f"from {PORT}.testing.scenarios import", src, flags=re.M)


@functools.lru_cache(maxsize=None)
def _twin_code(name: str, pkg: str):
    src = (TESTS / f"{name}.py").read_text()
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


def load_twin(pkg: str, name: str) -> types.ModuleType:
    """A fresh twin of reference test module `name` for `pkg`."""
    if pkg == PORT:
        install_shims()
    mod = types.ModuleType(f"_twin_{pkg}_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
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
        yield log
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


# -- one case ------------------------------------------------------------------------
def run_case(pkg: str, module: str, case: str) -> tuple:
    """One reference test case run on package `pkg`: (its outcome, the
    record of its calls). The outcome is "passed" or ("skipped", reason);
    a failed assertion raises."""
    base, _, pid = case.partition("[")
    fn_node = _functions(module)[base]
    params = dict(_param_ids(fn_node))["[" + pid if pid else ""]
    owner, _, fn_name = base.rpartition(".")
    same_start(pkg)
    with contextlib.ExitStack() as stack:
        stack.enter_context(seeded_uids())
        log = stack.enter_context(recording(pkg))
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        mod = load_twin(pkg, module)
        fn = getattr(getattr(mod, owner)(), fn_name) if owner else getattr(mod, fn_name)
        args = {**params, **({"monkeypatch": mp} if "monkeypatch" in [a.arg for a in fn_node.args.args] else {})}
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
