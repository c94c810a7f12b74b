"""The port's provisioning controller (`controllers/provisioning/provisioner.py`,
its `Batcher` and the capacity-buffer controller) against the reference's,
on the CPU.

Each case is wired directly in both packages, as a user wires it: a `Store`
on a `FakeClock`, a `Cluster` fed by `start_informers`, a
`FakeCloudProvider` and the same objects (nodepools, pods, volumes,
buffers; the port's carried over from the reference's) created in the same
order. The reference's `Provisioner` solves with its default
`TPUSolver(recover=False)`, the port's with `GPUSolver(device="cpu")` (or
the reference's default host FFD against the port's `FFDSolver()`, passed
explicitly: the port's default is `GPUSolver()` on the card). After `reconcile(force=True)` the
returned canonical `Results`, the solver's mode and backend and the
NodeClaims created in the store (`testing.canonical.canonical_node_claims`)
must be equal. Exact.

Covered: a hybrid pass, the host FFD solver and the port's GPU default, nodepool limits (the
scheduler's and the create-time refusal), static, deleting and not-Ready
pools and the "no ready nodepools" errors, a pod with an invalid PVC
skipped, capacity-buffer virtual pods, the watch-loss resync, the refused
metrics registry, `tests/test_churn_loop.py`'s `Batcher` cases (from :61,
the coalescing case driven through the provisioner itself) and
`tests/test_capacitybuffer.py`'s controller and `build_virtual_pods` cases.
"""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import pytest
import torch

from helpers import make_nodepool, make_pod, zone_spread
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.apis.capacitybuffer import CapacityBuffer, CapacityBufferSpec, ScalableRef
from karpenter_tpu.apis.nodepool import COND_NODEPOOL_READY
from karpenter_tpu.cloudprovider import catalog
from karpenter_tpu.kube import Container, Deployment, ObjectMeta, PodSpec, PodTemplate
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu.utils.resources import parse_resource_list
from karpenter_tpu_torch.solver.gpu import GPUSolver
from karpenter_tpu_torch.testing.canonical import canonical_node_claims, canonical_results
from karpenter_tpu_torch.testing.carry_over import carry_objects
from test_torch_hybrid_solve import preferred_affinity_pod
from test_torch_solve import BACKEND, _fresh_state  # noqa: F401 (autouse)
from test_torch_solve import clear_globals, next_start, same_state

torch.set_num_threads(1)

LINUX_AMD64 = [
    {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
    {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
]


def module(port: bool, name: str):
    return importlib.import_module(f"{'karpenter_tpu_torch' if port else 'karpenter_tpu'}.{name}")


class Pair:
    """The same cluster in both packages, each with its own provisioner."""

    def __init__(self, objects, types=None, solver: str = "tensor", metrics: bool = False, **options):
        types = types if types is not None else catalog.construct_instance_types()
        carried_objects, carried_types = carry_objects([list(objects), types])
        if metrics:
            from test_torch_metrics import fresh_default_recorders

            fresh_default_recorders()
        self.ref = self._side(False, objects, types, solver, options, metrics)
        self.port = self._side(True, carried_objects, carried_types, solver, options, metrics)
        clear_globals()

    @staticmethod
    def _side(port: bool, objects, types, solver: str, options: dict, metrics: bool = False):
        m = lambda name: module(port, name)  # noqa: E731
        clock = m("utils.clock").FakeClock()
        store = m("kube.store").Store(clock=clock)
        cluster = m("state.cluster").Cluster(store, clock)
        m("state.informer").start_informers(store, cluster)
        for o in objects:
            store.create(o)
        prov_mod = m("controllers.provisioning.provisioner")
        # with `metrics`: a registry for the provisioner and its solver, and
        # an event recorder, as the reference's Environment wires them
        registry = m("metrics").make_registry() if metrics else None
        events = m("events").Recorder(clock) if metrics else None
        s = None  # the reference's default: its host FFD
        if solver == "tensor":
            s = GPUSolver(device="cpu", registry=registry) if port else TPUSolver(recover=False, registry=registry)
        elif port:
            s = m("solver.ffd").FFDSolver()
        prov = prov_mod.Provisioner(store, cluster, m("cloudprovider.fake").FakeCloudProvider(types), clock, solver=s,
                                    options=prov_mod.ProvisionerOptions(**options), metrics=registry, recorder=events)
        return SimpleNamespace(store=store, cluster=cluster, clock=clock, prov=prov, m=m, registry=registry,
                               events=events)

    def sides(self):
        return (self.ref, self.port)

    def reconcile(self, **kw) -> dict:
        """One pass on each side from the same module state; the outcomes
        must be equal. Returns the port's."""
        start = next_start()
        out = []
        for side in self.sides():
            same_state(start)
            random.seed(start)  # claim names draw a random suffix: a later pass must draw new ones
            results = side.prov.reconcile(**kw)
            solver = side.prov.solver
            solved = bool(getattr(solver, "last_backend", ""))  # a pass that declined to solve leaves it empty
            out.append(dict(
                ran=results is not None,
                results=canonical_results(results) if results is not None else None,
                mode=getattr(solver, "last_solve_mode", None) if solved else None,
                backend=BACKEND.get(getattr(solver, "last_backend", None), getattr(solver, "last_backend", None)),
                claims=canonical_node_claims(side.store),
            ))
        want, got = out
        for key in ("ran", "mode", "backend"):
            assert got[key] == want[key], f"{key}: {got[key]!r}, reference {want[key]!r}"
        assert got["results"] == want["results"], "Results differ"
        assert got["claims"] == want["claims"], "NodeClaims differ"
        if self.port.registry is not None:
            from test_torch_metrics import assert_same_registry

            assert_same_registry(self.port.registry, self.ref.registry, "provisioner pass")
            assert self.port.events.reasons() == self.ref.events.reasons()
        return got


def pool(**kw):
    return make_nodepool(requirements=LINUX_AMD64, **kw)


def mixed_pods(n=12):
    sel = {"matchLabels": {"app": "web"}}
    pods = [make_pod(cpu="500m", name=f"p{i}") for i in range(n)]
    pods += [make_pod(cpu="1", name=f"s{i}", labels={"app": "web"}, tsc=[zone_spread(selector=sel)]) for i in range(4)]
    return pods


def test_hybrid_pass_matches_reference():
    """A pass over pods of which one carries a preferred pod affinity: the
    hybrid solve on both sides, its NodeClaims created in the store."""
    pair = Pair([pool()] + mixed_pods() + [preferred_affinity_pod()])
    got = pair.reconcile(force=True)
    assert (got["mode"], got["backend"]) == ("hybrid", "hybrid")
    assert got["claims"] and len(got["claims"]) == len(got["results"][0]) and not got["results"][2]
    # the claims are mirrored into the cluster: the next pass sees the pods
    # still pending and solves again against the in-flight claims
    got = pair.reconcile(force=True)
    assert got["ran"]


def test_in_window_pass_and_default_ffd():
    pair = Pair([pool()] + mixed_pods())
    got = pair.reconcile(force=True)
    assert (got["mode"], got["backend"]) == ("full", "gpu")
    pair = Pair([pool()] + mixed_pods(), solver="ffd")
    got = pair.reconcile(force=True)
    assert got["mode"] is None and got["claims"]
    assert type(pair.ref.prov.solver).__name__ == "FFDSolver"
    # the port's default solver is `GPUSolver()`, on the card: without one it
    # refuses rather than solve on the CPU
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner

    side = pair.port
    cloud = side.m("cloudprovider.fake").FakeCloudProvider([])
    if torch.cuda.is_available():
        solver = Provisioner(side.store, side.cluster, cloud, side.clock).solver
        assert isinstance(solver, GPUSolver) and solver.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Provisioner(side.store, side.cluster, cloud, side.clock)


@pytest.mark.parametrize("solver", ["tensor", "ffd"])
def test_nodepool_limits(solver):
    """Nodepool limits: the host scheduler caps new capacity at them (pods
    beyond get errors; the reference's tensor path does not read them, and
    the port's follows it), and `create_node_claim` refuses a claim once the
    pool's launched resources exceed them."""
    objects = [pool(limits={"cpu": "4"})] + [make_pod(cpu="1", name=f"p{i}") for i in range(10)]
    got = Pair(objects, solver=solver).reconcile(force=True)
    assert bool(got["results"][2]) == (solver == "ffd")
    pair = Pair(objects, solver=solver)
    for side in pair.sides():
        claims = side.store.list("NodeClaim")
        results = side.prov.schedule(side.prov.get_pending_pods())
        assert results.new_node_claims
        q = side.m("utils.quantity").Quantity
        side.cluster.nodepool_resources = lambda name, q=q: {"cpu": q.parse("100")}
        assert side.prov.create_node_claim(results.new_node_claims[0]) is None
        assert len(side.store.list("NodeClaim")) == len(claims)


def _static(np_):
    np_.spec.replicas = 2


def _deleting(np_):
    np_.metadata.deletion_timestamp = 1.0
    np_.metadata.finalizers = ["karpenter.sh/termination"]


def _not_ready(np_):
    np_.status.conditions.set_false(COND_NODEPOOL_READY, "NotReady", "not ready")


SKIPPED_POOLS = {"static": _static, "deleting": _deleting, "not_ready": _not_ready}


@pytest.mark.parametrize("kind", sorted(SKIPPED_POOLS))
@pytest.mark.parametrize("alone", [True, False])
def test_skipped_pools(kind, alone):
    """Static, deleting and not-Ready pools take no pods: alone, every pod
    gets "no ready nodepools"; beside a ready pool, the ready one takes all."""
    skipped = pool(name="skipped", weight=100)
    SKIPPED_POOLS[kind](skipped)
    objects = [skipped] + ([] if alone else [pool(name="ready")]) + [make_pod(cpu="1", name=f"p{i}") for i in range(3)]
    got = Pair(objects).reconcile(force=True)
    errors = dict(got["results"][2])
    if alone:
        assert errors == {f"default/p{i}": "no ready nodepools" for i in range(3)} and not got["claims"]
        assert got["mode"] is None
    else:
        assert not errors and {c[0] for c in got["claims"]} == {"ready"}


def test_invalid_pvc_pod_skipped():
    bad = make_pod(cpu="1", name="bad", volumes=[{"name": "v", "persistentVolumeClaim": {"claimName": "missing"}}])
    pair = Pair([pool(), make_pod(cpu="1", name="good"), bad])
    got = pair.reconcile(force=True)
    placed = [k for c in got["results"][0] for k in c[1]]
    assert placed == ["default/good"] and not got["results"][2]
    only_bad = Pair([pool(), bad]).reconcile(force=True)
    assert only_bad["ran"] and only_bad["results"] == ((), (), ()) and not only_bad["claims"]


def pod_template(name="chunk", cpu="2", memory="4Gi"):
    return PodTemplate(
        metadata=ObjectMeta(name=name),
        template_spec=PodSpec(containers=[Container(resources={"requests": parse_resource_list({"cpu": cpu, "memory": memory})})]),
    )


def buffer(name="buf", template="chunk", replicas=None, limits=None, scalable=None, percentage=None):
    spec = CapacityBufferSpec(replicas=replicas, percentage=percentage)
    if scalable is not None:
        spec.scalable_ref = scalable
    else:
        spec.pod_template_ref = template
    if limits:
        spec.limits = parse_resource_list(limits)
    return CapacityBuffer(metadata=ObjectMeta(name=name), spec=spec)


def resolve_buffers(pair: Pair) -> None:
    for side in pair.sides():
        side.m("controllers.capacitybuffer").CapacityBufferController(side.store, side.clock, side.prov).reconcile()


def test_capacity_buffer_virtual_pods():
    """With the CapacityBuffer gate on, the pass adds the buffer's virtual
    pods (a template whose spread selects its own labels) to the real ones."""
    pt = pod_template(cpu="1")
    pt.template_metadata.labels = {"app": "web"}
    pt.template_spec.topology_spread_constraints = [zone_spread(selector={"matchLabels": {"app": "web"}})]
    pair = Pair([pool(), pt, buffer(replicas=4), make_pod(cpu="500m", name="real")], capacity_buffer_enabled=True)
    resolve_buffers(pair)
    got = pair.reconcile(force=True)
    pods = [k for c in got["results"][0] for k in c[1]]
    assert "default/real" in pods and sum(k.startswith("default/capacity-buffer-buf-") for k in pods) == 4
    zones = {r[2] for c in got["results"][0] for r in c[3] if r[0] == wk.ZONE_LABEL_KEY and len(r[2]) == 1}
    assert len(zones) >= 2
    for side in pair.sides():
        assert side.cluster._buffer_pod_counts == {}
    off = Pair([pool(), pod_template(), buffer(replicas=2)])
    resolve_buffers(off)
    assert off.reconcile(force=True)["results"] == ((), (), ())


def test_watch_loss_resync():
    """A lost Pod watch event (the store's loss epoch moved) re-converges the
    cluster mirror once before the solve, on both sides."""
    pair = Pair([pool(), make_pod(cpu="1", name="p0")])
    calls = {False: 0, True: 0}
    for side, port in ((pair.ref, False), (pair.port, True)):
        real = side.cluster.resync_pods

        def spy(real=real, port=port):
            calls[port] += 1
            return real()

        side.cluster.resync_pods = spy
        with side.store._lock:
            side.store._watch_loss["Pod"] = 1
    pair.reconcile(force=True)
    assert calls == {False: 1, True: 1}
    pair.reconcile(force=True)
    assert calls == {False: 1, True: 1}


def test_batch_window_and_metrics_refused():
    """The batch window, and a metrics registry counting the passes as the
    reference's does (every family, exact; histograms by their counts): the
    claims created, the queue depth, the churn families, the effective-zone
    gauge, the solver's counters."""
    from karpenter_tpu_torch import metrics as pm

    pair = Pair([pool(), make_pod(cpu="1", name="p0")], metrics=True)
    got = pair.reconcile()  # no trigger: the window is closed
    assert not got["ran"]
    for side in pair.sides():
        side.prov.trigger("p0")
        side.clock.step(1.5)
    got = pair.reconcile()
    assert got["ran"] and got["claims"]
    reg = pair.port.registry
    assert reg.counter(pm.NODECLAIMS_CREATED_TOTAL).total() == 1
    assert reg.histogram(pm.SCHEDULER_SCHEDULING_DURATION).count() == 1
    assert reg.counter(pm.SOLVER_SOLVE_TOTAL).value(backend="gpu") == 1
    assert pair.port.prov.solver.last_solve_mode == "full"


# -- the Batcher (tests/test_churn_loop.py:61) ---------------------------------------

def _batcher():
    from karpenter_tpu_torch.controllers.provisioning.batcher import Batcher
    from karpenter_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    return clock, Batcher(clock, idle_seconds=1.0, max_seconds=10.0)


def test_batcher_reference_windows_without_solve_bracket():
    clock, b = _batcher()
    assert not b.ready()
    b.trigger("a")
    assert not b.ready()
    clock.step(1.5)
    assert b.ready()
    assert b.eta() == 0.0
    b.reset()
    assert not b.ready() and b.eta() is None
    b.trigger("b")
    clock.step(0.5)
    assert b.eta() == 0.5
    for _ in range(40):
        clock.step(0.5)
        b.trigger("c")
    assert b.ready()  # the max window fires under a steady trickle


def test_batcher_triggers_during_solve_arm_the_drain():
    _clock, b = _batcher()
    b.begin_solve()
    for i in range(5):
        b.trigger(str(i))
    assert b.end_solve() == 5
    assert b.ready() and b.pending() == 5
    b.reset()
    assert not b.ready()


def test_batcher_no_triggers_during_solve_means_no_drain():
    _clock, b = _batcher()
    b.begin_solve()
    assert b.end_solve() == 0
    b.trigger("after")
    assert not b.ready()


def test_triggers_during_a_pass_coalesce_into_one_followup():
    """Pods created during a pass coalesce into exactly one follow-up pass
    whose batch holds all of them, with no idle wait."""
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner
    from karpenter_tpu_torch.solver.ffd import FFDSolver

    pair = Pair([pool()] + [make_pod(cpu="500m", name=f"a{i}") for i in range(3)])
    side = pair.port
    prov: Provisioner = side.prov
    prov.solver = FFDSolver()
    seen: list[int] = []
    real = prov.solver.solve
    carried = carry_objects([make_pod(cpu="500m", name=f"b{i}") for i in range(7)])

    def spying_solve(snap):
        seen.append(len(snap.pods))
        if len(seen) == 1:
            for p in carried:  # a burst while the solve is in flight
                side.store.create(p)
                prov.trigger(p.metadata.name)
        return real(snap)

    prov.solver.solve = spying_solve
    for i in range(3):
        prov.trigger(f"a{i}")
    side.clock.step(1.0)
    assert prov.reconcile() is not None and seen == [3]
    assert prov.batcher.ready()  # the in-flight triggers armed the drain
    assert prov.reconcile() is not None and seen == [3, 10]
    assert not prov.batcher.ready()


# -- the capacity-buffer controller (tests/test_capacitybuffer.py) -------------------

BUFFERS = {
    "pod_template": ([pod_template(), buffer(replicas=3)], 3, True),
    "missing_template": ([buffer(template="ghost", replicas=2)], None, False),
    "limits_bound": ([pod_template(cpu="2"), buffer(replicas=10, limits={"cpu": "5"})], 2, True),
    "limits_alone": ([pod_template(cpu="1", memory="1Gi"), buffer(limits={"cpu": "4"})], 4, True),
    "percentage": ([Deployment(metadata=ObjectMeta(name="web"), replicas=10),
                    buffer(scalable=ScalableRef(kind="Deployment", name="web"), percentage=20)], 2, True),
    "percentage_floor": ([Deployment(metadata=ObjectMeta(name="web"), replicas=3),
                          buffer(scalable=ScalableRef(kind="Deployment", name="web"), percentage=10)], 1, True),
    "replicas_and_percentage": ([Deployment(metadata=ObjectMeta(name="web"), replicas=10),
                                 buffer(scalable=ScalableRef(kind="Deployment", name="web"), percentage=50, replicas=2)],
                                5, True),
}


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_buffer_controller_matches_reference(name):
    objects, replicas, ready = BUFFERS[name]
    pair = Pair([pool()] + objects)
    resolve_buffers(pair)
    got = []
    for side in pair.sides():
        cb = side.store.list("CapacityBuffer")[0]
        cond = cb.status.conditions.get("ReadyForProvisioning")
        got.append((cb.status.replicas, cb.status.pod_template_ref, cond.status, cond.reason, cond.message))
    assert got[0] == got[1]
    assert got[1][0] == replicas and (got[1][2] == "True") == ready


def test_build_virtual_pods_matches_reference():
    from karpenter_tpu.controllers.capacitybuffer.controller import build_virtual_pods as ref_build
    from karpenter_tpu_torch.apis.capacitybuffer import is_virtual_pod
    from karpenter_tpu_torch.controllers.capacitybuffer import build_virtual_pods

    cb = buffer(replicas=2)
    cb.status.replicas = 2
    spec = PodSpec(containers=[Container(resources={"requests": parse_resource_list({"cpu": "1"})})],
                   volumes=[{"name": "d", "persistentVolumeClaim": {"claimName": "x"}}, {"name": "cfg", "configMap": {}}])
    p_cb, p_spec = carry_objects([cb, spec])
    want = ref_build(cb, spec, {"app": "web"})
    got = build_virtual_pods(p_cb, p_spec, {"app": "web"})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert is_virtual_pod(g)
        assert g.spec.priority == w.spec.priority < -(2**30)
        assert [v["name"] for v in g.spec.volumes] == ["cfg"]
        assert (g.metadata.name, g.metadata.uid, g.metadata.labels, g.metadata.annotations) == (
            w.metadata.name, w.metadata.uid, w.metadata.labels, w.metadata.annotations)
    cb.status.replicas = 0
    assert build_virtual_pods(carry_objects(cb), p_spec) == []


# -- the provisioner's metrics (provisioner.py:88-106, :210-225; tests/test_effective_zone_metric.py) --

@pytest.mark.parametrize("solver", ["tensor", "ffd"])
def test_effective_zone_gauge_counts_as_the_reference(solver):
    """Pods pinned to an unoffered zone, to one zone, and unconstrained:
    every family equal to the reference's after each pass (the host FFD
    publishes the effective-zone counts, the tensor path clears them), and
    the gauge dropped once the stuck pod is gone."""
    from karpenter_tpu_torch import metrics as pm

    pods = [make_pod(cpu="100m", name="stuck", node_selector={wk.ZONE_LABEL_KEY: "test-zone-nowhere"}),
            make_pod(cpu="100m", name="pinned", node_selector={wk.ZONE_LABEL_KEY: "test-zone-a"}),
            make_pod(cpu="100m", name="free")]
    pair = Pair([pool()] + pods, solver=solver, metrics=True)
    pair.reconcile(force=True)
    g = pair.port.registry.gauge(pm.SCHEDULER_PENDING_PODS_BY_EFFECTIVE_ZONE)
    if solver == "ffd":
        assert g.value(zone="test-zone-nowhere") == 1.0 and g.value(zone="flexible") == 1.0
    else:
        assert g.collect() == []
    assert pair.port.registry.gauge(pm.SCHEDULER_UNSCHEDULABLE_PODS).value() == 1.0
    for side in pair.sides():
        side.store.delete("Pod", "stuck", namespace="default")
    pair.reconcile(force=True)
    assert g.value(zone="test-zone-nowhere") == 0.0


def test_hybrid_passes_count_as_the_reference():
    """Two hybrid passes with a registry and an event recorder on each
    side: the solver's hybrid counters, the churn families and the events
    equal the reference's."""
    from karpenter_tpu_torch import metrics as pm

    pair = Pair([pool()] + mixed_pods() + [preferred_affinity_pod()], metrics=True)
    pair.reconcile(force=True)
    pair.reconcile(force=True)
    reg = pair.port.registry
    assert reg.counter(pm.SOLVER_HYBRID_RESIDUAL_TOTAL).total() >= 1
    assert reg.counter(pm.NODECLAIMS_CREATED_TOTAL).total() >= 1


def test_podtracer_stamps_dispatch_and_solve():
    """A pod tracer on the store's delivery seam and the provisioner: the
    pass's batch note rides the solve's trace and the traced pods complete
    at placement, with the same records (outcome, staging, stage names) as
    on the reference's side."""
    from karpenter_tpu_torch.obs.trace import TraceRecorder

    pair = Pair([pool()], metrics=True)
    pods = [make_pod(cpu="100m", name=f"t{i}") for i in range(3)]
    carried = carry_objects(pods)
    tracers = []
    for side, objs in ((pair.ref, pods), (pair.port, carried)):
        # one large SLO target on both sides: the breach count compares
        # wall-clock latencies, which suite load can push past the default
        tracer = side.m("obs.podtrace").PodTracer(registry=side.registry, slo_seconds=3600.0)
        side.store.set_event_tracer(tracer)
        side.prov.podtracer = tracer
        if side is pair.port:
            side.prov.solver.recorder = TraceRecorder(enabled=True)
        for o in objs:
            side.store.create(o)
        tracers.append(tracer)
    pair.reconcile(force=True)
    want, got = (t.dump() for t in tracers)

    def shape(d):
        return ([(e["uid"], e["name"], e["outcome"], e["staged"], sorted(e["stages"])) for e in d["events"]],
                {k: d[k] for k in ("completed", "in_flight", "awaiting_bind", "cancelled", "deliveries")},
                {k: v for k, v in d["slo"].items() if k != "burn_rate"})

    assert shape(got) == shape(want) and got["completed"] == 3
    batch = pair.port.prov.solver._trace.attribution["event_batch"]
    assert batch["count"] == 3 and pair.port.prov.solver._staged_event_batch is None
