"""The port's dynamic resource allocation against the reference's, on the CPU.

The reference's own DRA tests (`tests/test_dra.py`, `test_dra_depth.py`,
`test_dra_superposition.py`; `test_torch_dra_cel.py` takes
`test_dra_cel.py`) are run twice per case: once as they are, and once as
a twin whose every `karpenter_tpu` import names `karpenter_tpu_torch`
(`helpers` becomes the port's `testing.scenarios`, the DRA test modules
they import from become their twins). Both runs start from the same module
state: pod names counted from 1, uids from one seeded generator, the
`random` stream and both hostname counters started again, both CEL parse
caches empty. While a run lasts, the package's DRA entry points record
what each call returned (`recording`): CEL verdicts and errors,
`device_matches_selectors`, claim resolution, every allocator and tracker
call with the allocator's or tracker's state after it, `Scheduler.solve`'s
canonical `Results` with its allocator's state, and the store after each
KWOK driver or device-allocation controller reconcile. The two records
must be equal, and the reference's own assertions must hold in the twin.
Tolerance: exact.

Two classes of `test_dra.py` need the operator's `Environment`, which the
port does not have yet (`TestEndToEnd`, `TestDeviceAllocationControllerDepth`;
ROADMAP Queue 1 item 7). Their flows are wired by hand here instead: the
KWOK driver, the device-allocation controller and a store, with
`reconcile()` called in turn (`test_controller_flow_matches_reference`).
`test_carry_over_keeps_dra_objects` holds a reference store with every DRA
kind, carried over, to the reference's names, uids, resource versions and
order.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import importlib
import itertools
import random
import re
import sys
import types
import uuid
from enum import Enum
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
REF, PORT = "karpenter_tpu", "karpenter_tpu_torch"

# the reference's DRA test modules, in import order (later ones import the
# earlier ones' builders), and the classes left to the operator item
TWIN_MODULES = ("test_dra", "test_dra_superposition", "test_dra_depth", "test_dra_cel")
NEEDS_ENVIRONMENT = {"test_dra": ("TestEndToEnd", "TestDeviceAllocationControllerDepth")}
UID_SEED = 16


def reference_cases(name: str) -> list[str]:
    """Every test of a reference module as "Class.method" or "function",
    read from its source (so every worker collects the same list)."""
    tree = ast.parse((TESTS / f"{name}.py").read_text())
    skip = NEEDS_ENVIRONMENT.get(name, ())
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test") and node.name not in skip:
            out += [f"{node.name}.{f.name}" for f in node.body
                    if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")]
    return out


# -- the twin modules -------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _twin_code(name: str, pkg: str):
    src = (TESTS / f"{name}.py").read_text()
    for dep in TWIN_MODULES:
        src = re.sub(rf"^from {dep} import", f"from _twin_{pkg}_{dep} import", src, flags=re.M)
    if pkg == PORT:
        src = src.replace("from karpenter_tpu.operator import Environment", "Environment = None  # operator: item 7")
        src = re.sub(r"\bkarpenter_tpu\b", PORT, src)
        src = re.sub(r"^from helpers import", f"from {PORT}.testing.scenarios import", src, flags=re.M)
    return compile(src, str(TESTS / f"{name}.py"), "exec")


def load_twins(pkg: str, upto: str) -> types.ModuleType:
    """Fresh twins of the reference's DRA test modules for `pkg`, up to
    `upto` (each executed anew, so the names they import are the ones
    bound now)."""
    mod = None
    for name in TWIN_MODULES[:TWIN_MODULES.index(upto) + 1]:
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


# -- plain data -------------------------------------------------------------------
def _requirement(r) -> tuple:
    return (r.key, r.operator().value, tuple(sorted(map(str, r.values))), r.complement, r.min_values, r.gte, r.lte)


def plain(x, _stack=()):
    """`x` as plain, comparable data: classes by name (either package's),
    dicts in their order, sets sorted, the scheduler's and allocator's
    objects in their canonical forms."""
    t = type(x)
    if t in (str, int, float, bool, type(None)):
        return x
    if id(x) in _stack:
        return ("<cycle>", t.__name__)
    stack = _stack + (id(x),)
    name = t.__name__
    if isinstance(x, BaseException):
        return ("raise", name, str(x))
    if t in (list, tuple):
        return [plain(v, stack) for v in x]
    if t is dict:
        return [("item", plain(k, stack), plain(v, stack)) for k, v in x.items()]
    if t in (set, frozenset):
        return ("set", sorted((plain(v, stack) for v in x), key=repr))
    if isinstance(x, Enum):
        return (name, x.name)
    if name == "Quantity":
        return ("Q", x.milli)
    if name == "Requirements":
        return ("Reqs", sorted(_requirement(r) for r in x.values()))
    if name == "Requirement":
        return ("Req", _requirement(x))
    if name == "Results":
        from karpenter_tpu_torch.testing.canonical import canonical_results

        return ("Results", plain(canonical_results(x)))
    if name == "_DeviceRef":
        return ("ref", list(x.device_id), x.driver, x.pool, x.device.name)
    if name == "Allocator":
        return allocator_state(x)
    if name == "AllocationTracker":
        return tracker_state(x)
    if name in ("InstanceType", "Store", "Cluster", "FakeClock", "SchedulingNodeClaim", "ExistingNode"):
        return (name, getattr(x, "name", None) if name == "InstanceType" else None)
    if callable(x) or isinstance(x, types.ModuleType):
        return ("<callable>", name)
    fields = getattr(x, "__dict__", None)
    if fields is None:
        fields = {k: getattr(x, k) for k in getattr(t, "__slots__", ()) if hasattr(x, k)}
    return (name, [(k, plain(v, stack)) for k, v in fields.items() if not k.startswith("_")])


def tracker_state(t) -> tuple:
    return ("tracker", sorted(map(list, t.exclusive)), plain(sorted(t.consumed.items(), key=repr)),
            plain(sorted(t.remaining_counters.items(), key=repr)))


def allocator_state(a) -> tuple:
    """What an allocator holds: class selectors, per-node devices, counter
    budgets, the base and loop trackers, in-cluster allocations, the claims'
    targets and template-allocation metadata."""
    return ("allocator", plain(a.class_selectors),
            [(node, [list(r.device_id) for r in refs]) for node, refs in a.node_devices.items()],
            plain(sorted(a.counter_budgets.items(), key=repr)), tracker_state(a.base_tracker),
            tracker_state(a.loop_tracker), plain(a.allocated_claims), sorted(a.claim_targets.items()),
            plain(sorted(a.claim_allocation_metadata.items())), sorted(a._template_it_by_name))


DRA_KINDS = ("DeviceClass", "ResourceSlice", "ResourceClaim", "ResourceClaimTemplate", "DRAConfig", "Node", "Pod")


def store_state(store) -> list:
    """Every DRA object of a store (and its nodes and pods), kind by kind in
    the store's order, with metadata."""
    return [(kind, [plain(o) for o in store.list(kind)]) for kind in DRA_KINDS]


# -- recording ----------------------------------------------------------------------
def _after_self(self_state):
    return lambda args, _kw, _out: self_state(args[0])


# (module under the package, owner attribute or None, attribute, what to record)
TARGETS = (
    ("scheduling.dynamicresources.cel", None, "evaluate", None),
    ("scheduling.dynamicresources.cel", None, "matches_device", None),
    ("scheduling.dynamicresources.allocator", None, "device_matches_selectors", None),
    ("scheduling.dynamicresources", None, "device_matches_selectors", None),
    ("scheduling.dynamicresources.allocator", None, "resolve_pod_claims", None),
    ("scheduling.dynamicresources", None, "resolve_pod_claims", None),
    ("scheduling.dynamicresources.allocator", None, "requirements_from_picks", None),
    ("scheduling.dynamicresources.allocator", "Allocator", "__init__", _after_self(allocator_state)),
    *(("scheduling.dynamicresources.allocator", "Allocator", m, None)
      for m in ("allocate", "allocate_for_node", "superpose_template_allocation", "resource_claim_allocation_metadata",
                "template_devices")),
    *(("scheduling.dynamicresources.allocator", "Allocator", m, _after_self(allocator_state))
      for m in ("commit", "commit_for_node", "commit_template_metadata", "release_instance_types")),
    ("scheduling.dynamicresources.allocator", "AllocationTracker", "available", None),
    *(("scheduling.dynamicresources.allocator", "AllocationTracker", m, _after_self(tracker_state))
      for m in ("take", "release", "copy")),
    ("controllers.provisioning.scheduling.scheduler", "Scheduler", "solve",
     lambda args, _kw, out: (plain(out), allocator_state(args[0].allocator) if args[0].allocator else None)),
    ("controllers.dynamicresources.kwokdriver", "DRAKwokDriver", "reconcile", _after_self(lambda d: store_state(d.store))),
    ("controllers.dynamicresources.deviceallocation", "DeviceAllocationController", "reconcile",
     _after_self(lambda c: store_state(c.store))),
)


# what the CEL cases also call: the quantity parser their comparands use
CEL_TARGETS = (("utils.quantity", "Quantity", "parse", None),)


@contextlib.contextmanager
def recording(pkg: str, extra: tuple = ()):
    """While it lasts, every entry point of `TARGETS` (and `extra`) in
    package `pkg` appends (label, what it returned or raised) to the
    yielded list."""
    log: list = []
    saved = []

    def wrap(owner, attr, label, post):
        real = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        fn = real.__func__ if isinstance(real, classmethod) else real

        @functools.wraps(fn)
        def recorded(*args, **kwargs):
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                log.append((label, "raise", type(e).__name__, str(e)))
                raise
            log.append((label, post(args, kwargs, out) if post else plain(out)))
            return out

        saved.append((owner, attr, real))
        setattr(owner, attr, classmethod(recorded) if isinstance(real, classmethod) else recorded)

    try:
        for mod_name, owner, attr, post in TARGETS + extra:
            mod = importlib.import_module(f"{pkg}.{mod_name}")
            target = getattr(mod, owner) if owner else mod
            wrap(target, attr, f"{mod_name.rsplit('.', 1)[-1]}.{owner + '.' if owner else ''}{attr}", post)
        yield log
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


def run_case(pkg: str, module: str, case: str) -> list:
    """One reference test case run on package `pkg`: the record of its
    calls."""
    same_start(pkg)
    with seeded_uids(), recording(pkg, CEL_TARGETS if module == "test_dra_cel" else ()) as log:
        mod = load_twins(pkg, module)
        owner, _, fn = case.rpartition(".")
        if owner:
            getattr(getattr(mod, owner)(), fn)()
        else:
            getattr(mod, fn)()
    return log


def assert_twin_case(module: str, case: str) -> None:
    want = run_case(REF, module, case)
    got = run_case(PORT, module, case)
    assert want, f"{module}::{case} recorded no call"
    assert len(got) == len(want), f"{module}::{case}: {len(got)} calls, the reference's {len(want)}"
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{module}::{case}: call {k} ({w[0]}) differs"


DRA_CASES = [(m, c) for m in ("test_dra", "test_dra_depth", "test_dra_superposition") for c in reference_cases(m)]


@pytest.mark.parametrize("module,case", DRA_CASES, ids=[f"{m}::{c}" for m, c in DRA_CASES])
def test_reference_case_matches(module, case):
    """One case of the reference's DRA tests: the port's twin passes the
    reference's assertions and records the reference's calls."""
    assert_twin_case(module, case)


def test_every_case_is_covered():
    """Each reference DRA test (but the two `Environment` classes) is one
    twin case here or in `test_torch_dra_cel.py`."""
    import test_dra
    import test_dra_depth
    import test_dra_superposition

    for mod in (test_dra, test_dra_depth, test_dra_superposition):
        collected = []
        for name, obj in vars(mod).items():
            if name.startswith("test_") and callable(obj):
                collected.append(name)
            elif name.startswith("Test") and isinstance(obj, type) and name not in NEEDS_ENVIRONMENT.get(mod.__name__, ()):
                collected += [f"{name}.{m}" for m in vars(obj) if m.startswith("test_")]
        assert sorted(collected) == sorted(reference_cases(mod.__name__)), mod.__name__


# -- the controllers, wired by hand ---------------------------------------------------
def _pkg(pkg: str) -> types.SimpleNamespace:
    imp = importlib.import_module
    return types.SimpleNamespace(
        kube=imp(f"{pkg}.kube"), objects=imp(f"{pkg}.kube.objects"), wk=imp(f"{pkg}.apis.labels"),
        res=imp(f"{pkg}.utils.resources"), clock=imp(f"{pkg}.utils.clock"), state=imp(f"{pkg}.state"),
        informer=imp(f"{pkg}.state.informer"), dra=imp(f"{pkg}.controllers.dynamicresources"),
        alloc=imp(f"{pkg}.scheduling.dynamicresources"),
    )


def controller_flow(pkg: str, template: bool) -> None:
    """`test_dra.py`'s `TestEndToEnd` / `TestDeviceAllocationControllerDepth`
    flows without the operator: a DRAConfig faking two GPUs onto every
    registered node, the KWOK driver publishing them, pods bound to the
    nodes (two sharing one claim, one whose claim comes from a template, one
    on a node without devices), the device-allocation controller persisting
    the allocations; then the pods leave one by one and the claims are
    released."""
    P = _pkg(pkg)
    K, wk = P.kube, P.wk
    meta = K.ObjectMeta
    store, clock = K.Store(), P.clock.FakeClock()
    cluster = P.state.Cluster(store, clock)
    P.informer.start_informers(store, cluster)

    def gpu(name):
        return K.Device(name=name, attributes={"gpu.example.com/model": "a100"},
                        capacity=P.res.parse_resource_list({"memory": "40Gi"}))

    store.create(K.DeviceClass(metadata=meta(name="gpu-class"), selectors=[]))
    store.create(P.dra.DRAConfig(metadata=meta(name="fake-gpus"), driver="gpu", devices=[gpu("g0"), gpu("g1")],
                                 node_selector={"matchLabels": {"gpu": "yes"}}))
    for n, has_gpu in (("n1", True), ("n2", True), ("n3", False)):
        labels = {wk.NODE_REGISTERED_LABEL_KEY: "true", **({"gpu": "yes"} if has_gpu else {})}
        store.create(K.Node(metadata=meta(name=n, labels=labels), spec=P.objects.NodeSpec(provider_id=f"kwok://{n}")))
    driver = P.dra.DRAKwokDriver(store)
    ctrl = P.dra.DeviceAllocationController(store, cluster, clock)
    driver.reconcile()
    store.create(K.ResourceClaim(metadata=meta(name="shared"),
                                 requests=[{"name": "gpus", "deviceClassName": "gpu-class", "count": 1}]))
    store.create(K.ResourceClaimTemplate(metadata=meta(name="pair"),
                                         requests=[{"name": "gpus", "deviceClassName": "gpu-class", "count": 2}]))

    def pod(name, node, claim):
        p = K.Pod(metadata=meta(name=name), spec=K.PodSpec(node_name=node))
        key = "resourceClaimTemplateName" if claim == "pair" else "resourceClaimName"
        p.spec.resource_claims = [{"name": "c0", key: claim}]
        store.create(p)

    pod("p1", "n1", "shared")
    pod("p2", "n1", "shared")
    pod("p3", "n2" if template else "n3", "pair")
    pod("p4", "n3", "shared")  # the claim lives on n1: no allocation here
    ctrl.reconcile()
    ctrl.reconcile()  # stable
    rc = store.get("ResourceClaim", "shared")
    assert rc.status.allocation["nodeName"] == "n1" and len(rc.status.reserved_for) == 3
    made = store.try_get("ResourceClaim", "p3-c0")
    assert (made is not None) == template
    for name in ("p1", "p4", "p2", "p3"):
        store.delete("Pod", name, grace=False)
        ctrl.reconcile()
    assert store.get("ResourceClaim", "shared").status.allocation is None
    # a config edit reaches the slices; a node that leaves takes its slice
    store.patch("DRAConfig", "fake-gpus", lambda c: c.devices.append(gpu("g2")))
    driver.reconcile()
    store.delete("Node", "n2", grace=False)
    driver.reconcile()
    assert len(store.list("ResourceSlice")) == 1


@pytest.mark.parametrize("template", (False, True), ids=("node-without-devices", "template-claim"))
def test_controller_flow_matches_reference(template):
    logs = []
    for pkg in (REF, PORT):
        same_start(pkg)
        with seeded_uids(), recording(pkg) as log:
            controller_flow(pkg, template)
        logs.append(log)
    want, got = logs
    assert sum(1 for w in want if w[0].endswith("reconcile")) == 9
    assert got == want


def dra_store(pkg: str):
    """A store with every DRA kind: a DeviceClass, a node's ResourceSlice of
    four partitions drawing on one shared counter set, a claim allocated
    on it, an open two-device claim with a matchAttribute constraint, a
    template and a DRAConfig."""
    P = _pkg(pkg)
    K = P.kube
    meta = K.ObjectMeta
    clock = P.clock.FakeClock()
    store = K.Store(clock=clock)
    store.create(K.DeviceClass(metadata=meta(name="gpu-class"), selectors=[{"cel": 'device.driver == "gpu"'}]))
    parts = [K.Device(name=f"p{i}", attributes={"gpu/profile": "1g"},
                      consumes_counters=[{"counterSet": "gpu-0", "counters": {"memory": "10"}}]) for i in range(4)]
    store.create(K.ResourceSlice(metadata=meta(name="n1-gpu"), driver="gpu", pool_name="n1", node_name="n1",
                                 devices=parts, shared_counters=[{"name": "gpu-0", "counters": {"memory": "40"}}]))
    clock.step(5)
    done = K.ResourceClaim(metadata=meta(name="done"), requests=[{"name": "r", "deviceClassName": "gpu-class"}])
    done.status.allocation = {"nodeName": "n1", "devices": [{"request": "r", "driver": "gpu", "pool": "n1",
                                                             "device": "p0"}]}
    done.status.reserved_for = ["some-pod"]
    store.create(done)
    for name, count in (("open", 2), ("extra", 1), ("late", 1)):
        store.create(K.ResourceClaim(metadata=meta(name=name, namespace="team"),
                                     requests=[{"name": "r", "deviceClassName": "gpu-class", "count": count}],
                                     constraints=[{"matchAttribute": "gpu/profile"}]))
    store.create(K.ResourceClaimTemplate(metadata=meta(name="tmpl"), requests=[{"name": "r", "allocationMode": "All"}]))
    store.create(P.dra.DRAConfig(metadata=meta(name="cfg"), devices=parts[:1]))
    store.patch("ResourceClaim", "done", lambda rc: rc.status.reserved_for.append("another-pod"))
    return store


def test_carry_over_keeps_dra_objects():
    """A reference snapshot whose store holds every DRA kind and whose
    instance types carry template devices and counter sets, carried over:
    the port's store holds the same objects, kind by kind, with the same
    names, uids, resource versions and order, as the port's classes."""
    from karpenter_tpu.cloudprovider.fake import instance_types_assorted
    from karpenter_tpu.solver.snapshot import SolverSnapshot
    from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference
    from karpenter_tpu_torch.testing.scenarios import dra_gpu_types

    import karpenter_tpu.kube as rkube
    import karpenter_tpu.utils.resources as rres

    with seeded_uids():
        store = dra_store(REF)
    its = instance_types_assorted(20)
    gpus = dra_gpu_types(its, rkube, rres)
    ref = SolverSnapshot(store=store, cluster=None, node_pools=[], instance_types={"p": its}, state_nodes=[],
                         daemonset_pods=[], pods=[], clock=store._clock, dra_enabled=True)
    port = snapshot_from_reference(ref)
    assert port.dra_enabled
    for kind in DRA_KINDS:
        want = [(o.metadata.namespace, o.metadata.name, o.metadata.uid, o.metadata.resource_version)
                for o in store.list(kind)]
        got = [(o.metadata.namespace, o.metadata.name, o.metadata.uid, o.metadata.resource_version)
               for o in port.store.list(kind)]
        assert got == want, kind
        assert [plain(o) for o in port.store.list(kind)] == [plain(o) for o in store.list(kind)], kind
        assert all(type(o).__module__.startswith(PORT + ".") for o in port.store.list(kind))
    assert [type(o).__name__ for o in port.store.list("DRAConfig")] == ["DRAConfig"]
    carried = port.instance_types["p"]
    assert [plain(it.dynamic_resources) for it in carried] == [plain(it.dynamic_resources) for it in its]
    assert [it.dynamic_resources_counters for it in carried] == [it.dynamic_resources_counters for it in its]
    assert sum(1 for it in carried if it.dynamic_resources) == len(gpus) > 0
    with seeded_uids():
        assert store_state(dra_store(PORT)) == store_state(store)


def test_allocator_over_carried_store_matches_reference():
    """The reference's and the port's `Allocator` over the same store (the
    port's carried over): the state each builds, and each allocation and
    commit in turn (the allocated claim passes through, the two-device
    claim takes two partitions, the next one the last partition the
    counter budget funds, the one after finds none), equal."""
    from karpenter_tpu.solver.snapshot import SolverSnapshot
    from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference

    with seeded_uids():
        store = dra_store(REF)
    ref = SolverSnapshot(store=store, cluster=None, node_pools=[], instance_types={}, state_nodes=[],
                         daemonset_pods=[], pods=[], clock=store._clock)
    port = snapshot_from_reference(ref)
    out = []
    for pkg, s in ((REF, store), (PORT, port.store)):
        a = importlib.import_module(f"{pkg}.scheduling.dynamicresources").Allocator(s, s._clock)
        steps = [allocator_state(a)]
        for names in (("done", "open"), ("extra",), ("late",)):
            claims = [c for c in s.list("ResourceClaim") if c.metadata.name in names]
            result, err = a.allocate_for_node("n1", claims)
            if err is None:
                a.commit_for_node("n1", result)
            steps += [plain((result, err)), allocator_state(a)]
        out.append(steps)
    assert out[1] == out[0]
    errs = [step[1] for step in out[0][1::2]]
    assert errs[:2] == [None, None] and errs[2] is not None
