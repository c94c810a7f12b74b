"""The port's disruption controller (`controllers/disruption/`, the NodeClaim
disruption controller, the consolidation simulator underneath) against the
reference's, on the CPU.

Each case builds its cluster as the reference's own disruption tests do,
through the reference's `Environment` (`tests/test_disruption.py`,
`test_consolidation_lp.py`, `test_tailcut_consolidation.py`), then wires
both packages directly (`Pair`): a `Store` on a `FakeClock` at the same
time, a `Cluster` fed by `start_informers`, the Environment's NodePools,
NodeClaims, Nodes, Pods and PodDisruptionBudgets created in the same order
(the port's carried over by class and field name), a `FakeCloudProvider`
over the same catalog, a `Provisioner` (the reference's
`TPUSolver(recover=False)`, the port's `GPUSolver(device="cpu")`), a
`NodeClaimDisruptionController` and a `DisruptionController` (the
reference's `Options(solver_backend="tpu")`, the port's default "gpu"; or
"ffd" on both). Every operation runs on each side from the same module
state (`random` and the claim hostname counters, as the provisioner tests
do: claim names draw a random suffix), and what it returns must be equal:
the `Command`s (`testing.canonical.canonical_command`), validation error
kinds, and the whole store (`testing.canonical.canonical_store`). Exact.

Covered: emptiness (with consolidateAfter, do-not-disrupt on the node and
on a pod, a zero budget), drift (the NodeClaim disruption controller's
Drifted condition, then the replacement), multi-node consolidation through
the LP (whole rounds, a three-node budget, the ranked ladder's fallback when
the Validator rejects the winner, every rung rejected), the binary search
(the "ffd" backend, and called directly), single-node consolidation of an
oversized node, the Validator's abort cases (nomination, budget, churn, a
pod bound during the 15 s window), PDBs, spot-to-spot with the feature gate
off and on, the Balanced policy, and the refused metrics registry.
"""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import pytest
import torch

from helpers import hostname_anti_affinity, make_nodepool, make_pod
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.apis.nodepool import Budget
from karpenter_tpu.kube.objects import ObjectMeta, PodDisruptionBudget
from karpenter_tpu.models import scheduler_model as jsm
from karpenter_tpu.operator import Environment
from karpenter_tpu.operator.options import Options
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch.models import scheduler_model as tsm
from karpenter_tpu_torch.solver.gpu import GPUSolver
from karpenter_tpu_torch.testing.canonical import canonical_command, canonical_store
from karpenter_tpu_torch.testing.carry_over import carry_objects
from test_torch_solve import clear_globals, next_start, same_state

torch.set_num_threads(1)

LINUX_AMD64 = [
    {"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
    {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
]
OD_ONLY = LINUX_AMD64 + [
    {"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In", "values": [wk.CAPACITY_TYPE_ON_DEMAND]},
]
KINDS = ("NodePool", "NodeClaim", "Node", "Pod", "PodDisruptionBudget")
MULTI = 3  # DisruptionController.methods: Emptiness, StaticDrift, Drift, MultiNode, SingleNode


@pytest.fixture(autouse=True)
def _fresh_state():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield


def module(port: bool, name: str):
    return importlib.import_module(f"{'karpenter_tpu_torch' if port else 'karpenter_tpu'}.{name}")


class Pair:
    """The cluster of a reference Environment, wired directly in both
    packages (module docstring). `backend` is "device" (the LP arm) or
    "ffd"; `clock_of(port)` may give a clock class of that package."""

    def __init__(self, env, backend: str = "device", spot_to_spot: bool = False, clock_of=None, metrics: bool = False):
        objects = sorted((o for kind in KINDS for o in env.store.list(kind)), key=lambda o: o.metadata.resource_version)
        types = env.cloud_provider.get_instance_types(None)
        carried, carried_types = carry_objects([objects, types])
        now = env.clock.now()
        if metrics:
            from test_torch_metrics import fresh_default_recorders

            fresh_default_recorders()
        self.ref = self._side(False, objects, types, now, backend, spot_to_spot, clock_of, metrics)
        self.port = self._side(True, carried, carried_types, now, backend, spot_to_spot, clock_of, metrics)
        clear_globals()

    @staticmethod
    def _side(port, objects, types, now, backend, spot_to_spot, clock_of, metrics=False):
        m = lambda name: module(port, name)  # noqa: E731
        clock_cls = clock_of(port) if clock_of is not None else m("utils.clock").FakeClock
        clock = clock_cls(start=now)
        store = m("kube.store").Store(clock=clock)
        cluster = m("state.cluster").Cluster(store, clock)
        m("state.informer").start_informers(store, cluster)
        for o in objects:
            store.create(o)
        cloud = m("cloudprovider.fake").FakeCloudProvider(types)
        # with `metrics`: one registry and one event recorder per side, wired
        # as the reference's Environment wires them
        registry = m("metrics").make_registry() if metrics else None
        events = m("events").Recorder(clock) if metrics else None
        solver = GPUSolver(device="cpu", registry=registry) if port else TPUSolver(recover=False, registry=registry)
        prov = m("controllers.provisioning.provisioner").Provisioner(store, cluster, cloud, clock, solver=solver,
                                                                     metrics=registry, recorder=events)
        opts = m("operator.options")
        name = "ffd" if backend == "ffd" else ("gpu" if port else "tpu")
        options = opts.Options(solver_backend=name,
                               feature_gates=opts.FeatureGates(spot_to_spot_consolidation=spot_to_spot))
        ncd = m("controllers.nodeclaim.disruption").NodeClaimDisruptionController(store, cluster, cloud, clock)
        dc = m("controllers.disruption.controller").DisruptionController(store, cluster, prov, cloud, clock, options,
                                                                         recorder=events, metrics=registry)
        return SimpleNamespace(store=store, cluster=cluster, clock=clock, cloud=cloud, prov=prov, ncd=ncd, dc=dc,
                               m=m, port=port, registry=registry, events=events)

    def run(self, fn):
        """`fn(side)` on each side from the same module state; the two
        results must be equal. Returns the port's."""
        start = next_start()
        out = []
        for side in (self.ref, self.port):
            same_state(start)
            random.seed(start)
            clear_globals()
            out.append(fn(side))
        want, got = out
        assert got == want
        if self.port.registry is not None:
            from test_torch_metrics import assert_same_registry

            assert_same_registry(self.port.registry, self.ref.registry, "disruption")
            assert [(e.involved_kind, e.involved_name, e.reason, e.message) for e in self.port.events.events] == \
                [(e.involved_kind, e.involved_name, e.reason, e.message) for e in self.ref.events.events]
        return got

    def flip(self) -> None:
        """consolidateAfter passes: the clock steps 40 s and the NodeClaim
        disruption controller runs (its conditions must agree)."""
        def step(side):
            side.clock.step(40)
            side.ncd.reconcile()
            return canonical_store(side.store)

        self.run(step)

    def reconcile(self) -> dict:
        return self.run(reconcile)


def reconcile(side) -> dict:
    """One forced disruption pass: the commands in flight, the store, the
    clock and whether the cluster was marked consolidated."""
    side.dc.reconcile(force=True)
    return dict(commands=[canonical_command(it.command) for it in side.dc.queue._items],
                store=canonical_store(side.store), now=side.clock.now(), consolidated=side.cluster.consolidated())


def method(side, i: int = MULTI):
    """The controller's method `i` with this round's candidates set, as
    `disrupt` sets them."""
    ctx = side.dc.ctx
    ctx.round_candidates = side.dc.get_candidates()
    ctx.node_pool_totals = None
    return side.dc.methods[i], ctx.round_candidates


def budgets(side, reason: str) -> dict:
    h = side.m("controllers.disruption.helpers")
    return h.build_disruption_budget_mapping(side.store, side.cluster, side.clock, reason)


# -- the reference's scenarios ---------------------------------------------------


def make_env(requirements=LINUX_AMD64, **opt):
    env = Environment(options=Options(**opt))
    np_ = make_nodepool(requirements=requirements)
    np_.spec.disruption.consolidate_after = "30s"
    env.store.create(np_)
    return env


def provision(env, pods):
    for p in pods:
        env.store.create(p)
    env.settle(rounds=6)
    assert all(p.spec.node_name for p in env.store.list("Pod")), "setup: pods must bind"
    return env


def fleet_env(n: int, requirements=OD_ONLY, budget: str = "100%", policy: str | None = None, cpu: str = "500m",
              swap_cpu: str = "500m"):
    """`tests/test_consolidation_tpu.build_fleet`: n underutilized one-pod
    nodes (hostname anti-affinity pods of `cpu`, then swapped for plain pods
    of `swap_cpu`)."""
    env = Environment(options=Options(solver_backend="tpu"))
    np_ = make_nodepool(requirements=requirements)
    np_.spec.disruption.consolidate_after = "30s"
    np_.spec.disruption.budgets = [Budget(nodes=budget)]
    if policy is not None:
        np_.spec.disruption.consolidation_policy = policy
    env.store.create(np_)
    sel = {"matchLabels": {"app": "x"}}
    pods = [make_pod(cpu=cpu, name=f"s{i}", labels={"app": "x"}, anti_affinity=[hostname_anti_affinity(sel)])
            for i in range(n)]
    for p in pods:
        env.store.create(p)
    env.settle()
    assert env.store.count("Node") == n
    for p in pods:
        env.store.delete("Pod", p.metadata.name)
    for i in range(n):
        env.store.create(make_pod(cpu=swap_cpu, name=f"f{i}", labels={"app": "f"}))
    env.settle(rounds=4)
    return env


def empty_node_env(**kw):
    env = make_env()
    provision(env, [make_pod(cpu="1", name="only-pod", **kw)])
    env.store.delete("Pod", "only-pod")
    return env


def oversized_env():
    env = make_env(requirements=OD_ONLY)
    provision(env, [make_pod(cpu="14", name="big"), make_pod(cpu="500m", name="small")])
    env.store.delete("Pod", "big")
    return env


# -- emptiness ----------------------------------------------------------------------


def test_emptiness_deletes_the_empty_node():
    pair = Pair(empty_node_env())
    pair.flip()
    got = pair.reconcile()
    assert len(got["commands"]) == 1 and got["commands"][0][0] == "Empty"
    got = pair.reconcile()  # the queue deletes the candidate: no replacement to wait for
    assert not got["commands"]


def test_emptiness_waits_for_consolidate_after():
    pair = Pair(empty_node_env())
    pair.run(lambda side: (side.clock.step(5), side.ncd.reconcile(), canonical_store(side.store))[2])
    assert not pair.reconcile()["commands"]


def test_do_not_disrupt_node_annotation_blocks():
    env = empty_node_env()
    node = env.store.list("Node")[0]
    env.store.patch("Node", node.metadata.name,
                    lambda n: n.metadata.annotations.__setitem__(wk.DO_NOT_DISRUPT_ANNOTATION_KEY, "true"))
    pair = Pair(env)
    pair.flip()
    assert not pair.reconcile()["commands"]


def test_zero_budget_blocks_and_keeps_polling():
    env = empty_node_env()
    np_ = env.store.list("NodePool")[0]
    np_.spec.disruption.budgets = [Budget(nodes="0")]
    env.store.update(np_)
    pair = Pair(env)
    pair.flip()
    got = pair.reconcile()
    assert not got["commands"] and not got["consolidated"]


# -- drift ------------------------------------------------------------------------------


def test_drift_replaces_the_drifted_node():
    env = make_env()
    provision(env, [make_pod(cpu="1", name="p")])
    np_ = env.store.list("NodePool")[0]
    np_.spec.template.labels = {"new-label": "v2"}  # changes the static hash
    env.store.update(np_)
    env.nodepool_hash.reconcile()
    pair = Pair(env)
    pair.flip()
    got = pair.reconcile()
    assert len(got["commands"]) == 1 and got["commands"][0][0] == "Drifted" and got["commands"][0][2]


def test_cloud_provider_drift_condition():
    env = make_env()
    provision(env, [make_pod(cpu="1", name="p")])
    pair = Pair(env)

    def drift(side):
        side.cloud.drifted = "CloudProviderDrifted"
        side.clock.step(10)
        side.ncd.reconcile()
        return canonical_store(side.store)

    store = pair.run(drift)
    claims = dict(store)["NodeClaim"]
    assert any(c[0] == "Drifted" and c[2] == "CloudProviderDrifted" for c in claims[0][9])


# -- multi-node consolidation --------------------------------------------------------


@pytest.mark.parametrize("n", [4, 6])
def test_multi_node_round_through_the_lp(n):
    pair = Pair(fleet_env(n))
    pair.flip()
    got = pair.reconcile()
    assert len(got["commands"]) == 1 and got["commands"][0][0] == "Underutilized"
    assert len(got["commands"][0][1]) >= 2
    # the replacement is not initialized: the command stays in flight
    got = pair.reconcile()
    assert len(got["commands"]) == 1


def test_multi_node_round_records_its_probes():
    pair = Pair(fleet_env(6))
    pair.flip()

    def lp(side):
        m, cands = method(side)
        cmd = m._lp_option(cands, side.clock.now() + 60.0)
        if side.port:
            probes = (m.last_round["sim_masked"], m.last_round["sim_scratch"])
        else:
            trace = next(t for t in reversed(side.prov.solver.recorder.traces()) if t.mode == "consolidate")
            probes = (trace.attribution["sim_masked"], trace.attribution["sim_scratch"])
        return canonical_command(cmd), probes

    cmd, probes = pair.run(lp)
    assert cmd[1] and probes[0] >= 1


def test_multi_node_budget_of_three():
    pair = Pair(fleet_env(6, budget="3"))
    pair.flip()
    got = pair.reconcile()
    assert len(got["commands"]) == 1 and len(got["commands"][0][1]) <= 3


def test_binary_search_with_the_ffd_backend():
    pair = Pair(fleet_env(6, cpu="1500m", swap_cpu="300m"), backend="ffd")
    pair.flip()
    got = pair.reconcile()
    assert len(got["commands"]) == 1 and len(got["commands"][0][1]) >= 2


def test_binary_search_called_directly():
    pair = Pair(fleet_env(5, cpu="1500m", swap_cpu="300m"))
    pair.flip()

    def first_n(side):
        m, cands = method(side)
        return canonical_command(m._first_n_consolidation_option(m.sort_candidates(cands)))

    assert pair.run(first_n)[1]


def _flaky(side, fail_first_n: int, calls: dict, monkeypatch):
    validation = side.m("controllers.disruption.validation")
    orig = validation.Validator.validate

    def flaky(self, cmd, delay_seconds=15.0):
        calls["n"] += 1
        calls["validated"].append(cmd.candidate_names())
        if calls["n"] <= fail_first_n:
            raise validation.ValidationError("churn", "forced by test")
        return orig(self, cmd, delay_seconds)

    monkeypatch.setattr(validation.Validator, "validate", flaky)


@pytest.mark.parametrize("fail_first_n", [1, 10**6])
def test_ranked_ladder_after_a_rejected_winner(fail_first_n, monkeypatch):
    """`test_tailcut_consolidation`'s cases: the winner's rejection pulls
    the next accepted rung; with every rung rejected, nothing is emitted
    after at most MULTI_NODE_VALIDATION_ATTEMPTS validations."""
    pair = Pair(fleet_env(6))
    pair.flip()

    def compute(side):
        calls = {"n": 0, "validated": []}
        with monkeypatch.context() as mp:
            _flaky(side, fail_first_n, calls, mp)
            m, cands = method(side)
            cmds = m.compute_commands(cands, budgets(side, m.reason))
        return [canonical_command(c) for c in cmds], calls["n"], calls["validated"]

    cmds, n, validated = pair.run(compute)
    if fail_first_n == 1:
        assert n == 2 and cmds and list(cmds[0][1]) == validated[1] != validated[0]
    else:
        assert cmds == [] and n <= 3


def test_empty_candidate_sets_short_circuit():
    pair = Pair(fleet_env(3))
    pair.flip()

    def empty(side):
        m, _ = method(side)
        cmd = m.compute_consolidation([])
        before = side.clock.now()
        validation = side.m("controllers.disruption.validation")
        with pytest.raises(validation.ValidationError):
            validation.Validator(m.ctx, m, mode="strict").validate(side.m("controllers.disruption.types").Command())
        return canonical_command(cmd), side.clock.now() - before

    assert pair.run(empty) == (("", (), (), None), 0.0)


# -- single-node consolidation ---------------------------------------------------------


def test_single_node_replaces_the_oversized_node():
    pair = Pair(oversized_env())
    pair.flip()
    got = pair.reconcile()
    assert len(got["commands"]) == 1 and len(got["commands"][0][1]) == 1 and got["commands"][0][2]


def test_when_empty_policy_blocks_underutilized():
    env = oversized_env()
    np_ = env.store.list("NodePool")[0]
    np_.spec.disruption.consolidation_policy = "WhenEmpty"
    env.store.update(np_)
    pair = Pair(env)
    pair.flip()
    assert not pair.reconcile()["commands"]


# -- the Validator -----------------------------------------------------------------------


@pytest.mark.parametrize("churn", ["nominated", "budget", "annotated"])
def test_validator_aborts(churn):
    pair = Pair(fleet_env(2))
    pair.flip()

    def validate(side):
        m, cands = method(side)
        eligible = [c for c in cands if m.should_disrupt(c)]
        if churn == "nominated":
            side.cluster.nominate_node(eligible[0].name())
        elif churn == "budget":
            budget = side.m("apis.nodepool").Budget
            side.store.patch("NodePool", eligible[0].node_pool.metadata.name,
                             lambda np_: setattr(np_.spec.disruption, "budgets", [budget(nodes="0")]))
        else:
            side.store.patch("Node", eligible[0].name(),
                             lambda n: n.metadata.annotations.__setitem__(wk.DO_NOT_DISRUPT_ANNOTATION_KEY, "true"))
        types = side.m("controllers.disruption.types")
        validation = side.m("controllers.disruption.validation")
        cmd = types.Command(reason="Underutilized", candidates=eligible[:1])
        with pytest.raises(validation.ValidationError) as e:
            validation.Validator(m.ctx, m, mode="strict").validate(cmd, delay_seconds=0)
        return e.value.kind, str(e.value)

    kind, _msg = pair.run(validate)
    assert kind == {"nominated": "nominated", "budget": "budget", "annotated": "churn"}[churn] or kind == "churn"


def test_pod_bound_during_the_window_aborts_emptiness():
    def clock_of(port):
        base = module(port, "utils.clock").FakeClock

        class ChurnClock(base):
            hook = None

            def sleep(self, seconds):
                if seconds >= 15.0 - 1e-9 and self.hook is not None:
                    hook, self.hook = self.hook, None
                    hook()
                self.step(seconds)

        return ChurnClock

    pair = Pair(empty_node_env(), clock_of=clock_of)
    pair.flip()

    def churn(side):
        node_name = side.store.list("Node")[0].metadata.name
        kube = side.m("kube.objects")
        res = side.m("utils.resources")

        def bind():
            side.store.create(kube.Pod(
                metadata=kube.ObjectMeta(name="late-pod", uid="late-pod-uid"),
                spec=kube.PodSpec(node_name=node_name, containers=[
                    kube.Container(resources={"requests": res.parse_resource_list({"cpu": "1"})})]),
            ))

        side.clock.hook = bind
        return reconcile(side)

    got = pair.run(churn)
    assert not got["commands"]


# -- PDBs, spot-to-spot, balanced ------------------------------------------------------------


def test_pdb_blocks_the_candidates():
    env = fleet_env(4)
    env.store.create(PodDisruptionBudget(metadata=ObjectMeta(name="f-pdb"), selector={"matchLabels": {"app": "f"}},
                                         max_unavailable=0))
    pair = Pair(env)
    pair.flip()
    got = pair.reconcile()
    assert not got["commands"]


@pytest.mark.parametrize("gate", [False, True])
def test_spot_to_spot(gate):
    spot = LINUX_AMD64 + [{"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In", "values": [wk.CAPACITY_TYPE_SPOT]}]
    pair = Pair(fleet_env(4, requirements=spot), spot_to_spot=gate)
    pair.flip()
    got = pair.reconcile()
    if gate:
        assert got["commands"]


def test_balanced_policy():
    pair = Pair(fleet_env(5, policy="Balanced"))
    pair.flip()
    pair.reconcile()


def test_do_not_disrupt_pod_excludes_its_node():
    env = fleet_env(4)
    pod = env.store.get("Pod", "f0")
    env.store.delete("Pod", "f0")
    env.settle(rounds=1)
    env.store.create(make_pod(cpu="500m", name="f0", labels={"app": "f"}, node_name=pod.spec.node_name,
                              annotations={wk.DO_NOT_DISRUPT_ANNOTATION_KEY: "true"}))
    pair = Pair(env)
    pair.flip()

    def candidates(side):
        return sorted(c.name() for c in side.dc.get_candidates())

    names = pair.run(candidates)
    assert pod.spec.node_name not in names and len(names) == 3
    pair.reconcile()


def test_metrics_and_cluster_cost_are_refused():
    """A metrics registry counts the disruption pass as the reference's does
    (the eligible-nodes gauge, the decisions, the decision histogram's
    count; exact). A `ClusterCost` is no longer refused (`state/cost.py` is
    ported): a controller built with one reads the balanced nodepool totals
    from it as the reference's does (exact)."""
    from karpenter_tpu_torch import metrics as pm

    def balanced_totals(side):
        cost = side.m("state.cost")
        cc = cost.ClusterCost(side.store, side.cloud)
        cost.start_cost_informer(side.store, cc)
        dc = side.m("controllers.disruption.controller").DisruptionController(
            side.store, side.cluster, side.prov, side.cloud, side.clock, side.dc.options, cluster_cost=cc)
        assert dc.ctx.cluster_cost is cc
        dc.ctx.round_candidates = dc.get_candidates()
        return {k: (v.total_cost, v.total_disruption_cost) for k, v in dc.ctx.balanced_totals().items()}

    pair = Pair(empty_node_env(), metrics=True)
    pair.flip()
    assert pair.run(balanced_totals)
    pair.reconcile()
    pair.reconcile()
    p = pair.port
    assert p.registry.counter(pm.DISRUPTION_DECISIONS_TOTAL).total() >= 1
    assert p.registry.histogram(pm.DISRUPTION_DECISION_EVAL_DURATION).count(method="Emptiness") >= 1
    assert p.dc.options.solver_backend == "gpu" and not p.dc.options.validate()


# -- the disruption metrics and the round's flight record ------------------------------

# the port's own stages inside the LP round's spans (solver/consolidation.py,
# solver/simulate.py) and the collector's `gc2` pauses, left out where the
# round's span tree meets the reference's
ROUND_PORT_SPANS = frozenset({"tensors", "K5 globalpack", "rounding", "K6 upload", "K6 kernel", "K6 download",
                              "ladder", "sim base", "sim_mask_encode", "solve_prepared", "sim scratch", "gc2"})


def _round_view(trace, port: bool) -> dict:
    def tree(spans):
        return [(s.name, tree(s.children)) for s in spans if not (port and s.name in ROUND_PORT_SPANS)]

    return dict(mode=trace.mode, backend=trace.backend, n_pods=trace.n_pods, spans=tree(trace.spans),
                notes=dict(trace.attribution))


@pytest.mark.parametrize("n", [4, 6])
def test_lp_round_counts_and_traces_as_the_reference(n):
    """A disruption pass through the LP on each side with a registry: every
    family equal (the proposal batch, the LP iterations, the validations,
    the savings gauge, the eligible-nodes gauge, the decisions), and the
    round's trace (spans `encode_candidates`, `lp_repack`, `round`,
    `validate`; the proposal and probe notes) equal the reference's."""
    from karpenter_tpu_torch import metrics as pm
    from karpenter_tpu_torch.obs.trace import TraceRecorder

    pair = Pair(fleet_env(n), metrics=True)
    ref_rec = pair.ref.prov.solver.recorder = type(pair.ref.prov.solver.recorder)(enabled=True)
    port_rec = pair.port.prov.solver.recorder = TraceRecorder(enabled=True)
    pair.flip()
    got = pair.reconcile()
    assert len(got["commands"]) == 1
    reg = pair.port.registry
    assert reg.counter(pm.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).value(proposer="lp") >= 1
    assert reg.counter(pm.SOLVER_CONSOLIDATION_LP_ITERATIONS_TOTAL).total() == 8 * 300
    assert reg.counter(pm.SOLVER_CONSOLIDATION_VALIDATION_TOTAL).value(decision="accept") >= 1
    assert reg.gauge(pm.SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR).value(proposer="lp") > 0

    def rounds(rec):
        return [t for t in rec.traces() if t.mode == "consolidate"]

    (want,), (round_trace,) = rounds(ref_rec), rounds(port_rec)
    assert _round_view(round_trace, True) == _round_view(want, False)
    assert [s.name for s in round_trace.spans if s.name != "gc2"][:3] == ["encode_candidates", "lp_repack", "round"]
    view = pair.port.dc.methods[3].last_round
    assert view["proposals"] == round_trace.attribution["proposals"] and "K5 globalpack" in view["stages"]
    sims = [t for t in port_rec.traces() if t.mode == "sim"]
    assert len(sims) == round_trace.attribution["sim_masked"] and all(t.backend == "gpu" for t in sims)


def test_binary_search_counts_as_the_reference():
    """The binary search called directly on each side with a registry: its
    proposals and savings gauge equal the reference's."""
    pair = Pair(fleet_env(5, cpu="1500m", swap_cpu="300m"), metrics=True)
    pair.flip()

    def first_n(side):
        m, cands = method(side)
        cmd = canonical_command(m._first_n_consolidation_option(m.sort_candidates(cands)))
        pm = side.m("metrics")
        return cmd, side.registry.counter(pm.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).value(proposer="binary-search"), \
            side.registry.gauge(pm.SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR).value(proposer="binary-search")

    cmd, proposals, savings = pair.run(first_n)
    assert cmd[1] and proposals >= 1 and savings > 0


@pytest.mark.parametrize("churn", ["nominated", "budget", "annotated"])
def test_validator_counts_its_failures_as_the_reference(churn):
    """`test_validator_aborts` with a registry on each side: the failed
    validations counter agrees."""
    pair = Pair(fleet_env(2), metrics=True)
    pair.flip()

    def validate(side):
        m, cands = method(side)
        eligible = [c for c in cands if m.should_disrupt(c)]
        if churn == "nominated":
            side.cluster.nominate_node(eligible[0].name())
        elif churn == "budget":
            budget = side.m("apis.nodepool").Budget
            side.store.patch("NodePool", eligible[0].node_pool.metadata.name,
                             lambda np_: setattr(np_.spec.disruption, "budgets", [budget(nodes="0")]))
        else:
            side.store.patch("Node", eligible[0].name(),
                             lambda n: n.metadata.annotations.__setitem__(wk.DO_NOT_DISRUPT_ANNOTATION_KEY, "true"))
        types = side.m("controllers.disruption.types")
        validation = side.m("controllers.disruption.validation")
        cmd = types.Command(reason="Underutilized", candidates=eligible[:1])
        with pytest.raises(validation.ValidationError):
            validation.Validator(m.ctx, m, mode="strict", metrics=side.registry).validate(cmd, delay_seconds=0)
        return side.registry.counter(side.m("metrics").DISRUPTION_FAILED_VALIDATIONS_TOTAL).total()

    assert pair.run(validate) >= 1


def test_rejected_rungs_count_as_the_reference(monkeypatch):
    """Every rung rejected by the Validator: the LP round's validation
    counters and the queue's events agree across the packages."""
    pair = Pair(fleet_env(6), metrics=True)
    pair.flip()

    def compute(side):
        calls = {"n": 0, "validated": []}
        with monkeypatch.context() as mp:
            _flaky(side, 10**6, calls, mp)
            m, cands = method(side)
            cmds = m.compute_commands(cands, budgets(side, m.reason))
        return [canonical_command(c) for c in cmds], calls["n"]

    cmds, n = pair.run(compute)
    assert cmds == [] and 1 <= n <= 3


@pytest.mark.parametrize("fault", ["kernel-refusal", "host"])
def test_a_kernel_refusal_fails_the_lp_round(fault, monkeypatch):
    """K5's wrapper refusing its arguments on the card's path
    (`build.require`: a `KernelError` that is also a ValueError) fails the
    round: the binary search never answers for it, and the round's trace is
    still committed. A host ValueError from the proposer falls back to the
    binary search, as the reference's does."""
    from karpenter_tpu_torch.kernels import build
    from karpenter_tpu_torch.kernels import globalpack as kgp
    from karpenter_tpu_torch.obs.trace import TraceRecorder

    pair = Pair(fleet_env(6), metrics=True)
    pair.flip()
    side = pair.port
    m, cands = method(side)
    rec = side.prov.solver.recorder = TraceRecorder(enabled=True)
    searched = []
    real_search = m._first_n_consolidation_option
    monkeypatch.setattr(m, "_first_n_consolidation_option", lambda *a: searched.append(1) or real_search(*a))

    def refused(t, onehot, compat_qn, pend_mass, pend_weight, d0, y0, n_iters):
        if fault == "kernel-refusal":
            build.require(d0, torch.device("cuda"), torch.float32, "d0")
        raise ValueError("a host fault")

    monkeypatch.setattr(kgp, "globalpack", refused)
    if fault == "kernel-refusal":
        with pytest.raises(build.KernelArgError, match="d0: on cpu, expected cuda"):
            m.compute_commands(cands, budgets(side, m.reason))
        assert searched == []
    else:
        m.compute_commands(cands, budgets(side, m.reason))
        assert searched == [1]
    (round_trace,) = [t for t in rec.traces() if t.mode == "consolidate"]
    assert round_trace.backend == "lp" and "proposals" not in round_trace.attribution
    pm = side.m("metrics")
    assert side.registry.counter(pm.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).value(proposer="lp") == 0
