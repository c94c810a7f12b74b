"""The consolidation fleet and one consolidation round over it, the port
against the reference, on the CPU.

`testing.scenarios.build_consolidation_fleet(n)` fabricates the objects that
`bench._build_consolidation_fleet(n)` gets from the reference's operator
(kwok, lifecycle, registration, initialization, the NodeClaim disruption
controller). The reference's fleet is built with its pods' uids drawn from
`scenarios.fleet_pod_uids()` instead of `uuid.uuid4()` (`reference_fleet`
patches the test helpers' `make_pod`): the host scheduler breaks ties
between the identical fleet pods by uid. Held equal object for object in a
canonical form (every field but resource versions and the uids of objects
other than pods, timestamps relative to the clock's start, label and
annotation order kept), and the cluster's node order equal.

The round: the reference wired directly (its `Provisioner` with
`TPUSolver(recover=False)`, its `DisruptionController` with
`Options(solver_backend="tpu")`) over its Environment-built fleet, the port
(`GPUSolver(device="cpu")`, `Options()`, whose backend is "gpu") over its
own fleet. One LP decision, `MultiNodeConsolidation._lp_option` over every
candidate in the controller's order, must give the same `Command`
(`testing.canonical.canonical_command`), masked and scratch probe counts
and the same round counters in a metrics registry (`round_counters`: the
proposal batch, the LP iterations, the validations, the savings gauge);
then one `DisruptionController.reconcile(force=True)` must execute the same
command and leave the same NodeClaims in the store. At 8 nodes both sides
run here; the reference's 5000-node round (the benchmark's target,
`bench_consolidation_lp`) is stored in
`karpenter_tpu_torch/fixtures/consolidation/fleet_5000_lp_command.json`,
which `chip_smoke.py` holds the port to on the card. Write it (about 4
minutes on the CPU, most of it the reference's fleet build) with

    JAX_PLATFORMS=cpu python tests/test_torch_consolidation_fleet.py --write
"""

from __future__ import annotations

import json
import os
import random
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__":
    import conftest  # noqa: F401  (the test suite's JAX settings, before JAX loads)

import bench  # noqa: E402
from karpenter_tpu.models import scheduler_model as jsm  # noqa: E402
from karpenter_tpu_torch.models import scheduler_model as tsm  # noqa: E402
from karpenter_tpu_torch.testing.canonical import (  # noqa: E402
    canonical_command,
    canonical_node_claims,
    json_form,
)
from karpenter_tpu_torch.testing.scenarios import build_consolidation_fleet, fleet_pod_uids  # noqa: E402
from test_torch_solve import clear_globals, next_start, same_state  # noqa: E402

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parents[1] / "karpenter_tpu_torch" / "fixtures" / "consolidation" / \
    "fleet_5000_lp_command.json"
FLEET_NODES = 5000
ROUND_SEED = 0  # `random`'s seed before each side's round (claim names draw a random suffix)


@pytest.fixture(autouse=True)
def _fresh_state():
    jsm.reset_bucket_highwater()
    tsm.reset_bucket_highwater()
    yield


# -- the fleet -------------------------------------------------------------------


def reference_fleet(n: int, hetero: bool = False):
    """`bench._build_consolidation_fleet(n)` with the pods' uids drawn from
    `fleet_pod_uids()` in creation order."""
    import helpers

    uids = fleet_pod_uids()
    real = helpers.make_pod

    def make_pod(*args, **kwargs):
        pod = real(*args, **kwargs)
        pod.metadata.uid = next(uids)
        return pod

    helpers.make_pod = make_pod
    try:
        return bench._build_consolidation_fleet(n, hetero_prices=hetero)
    finally:
        helpers.make_pod = real


def _q(d) -> list:
    return [(k, v.milli) for k, v in d.items()]


def _conds(items) -> list:
    items = items.conditions if hasattr(items, "conditions") else items
    return [(c.type, c.status, c.reason, c.message, c.last_transition_time) for c in items]


def canonical_fleet(store, t0: float) -> dict:
    """Every NodePool, NodeClaim, Node and Pod in creation order, with every
    field but resource versions and the uids of all but pods (times relative
    to `t0`, dict order kept)."""
    out = {}
    for kind in ("NodePool", "NodeClaim", "Node", "Pod"):
        rows = []
        for o in sorted(store.list(kind), key=lambda o: o.metadata.resource_version):
            m = o.metadata
            row = [m.name, m.namespace, list(m.labels.items()), list(m.annotations.items()), list(m.finalizers),
                   [(r.kind, r.name, r.api_version, r.controller, r.block_owner_deletion) for r in m.owner_references],
                   m.creation_timestamp - t0, m.deletion_timestamp, m.generation <= 2, repr(o.spec)]
            if kind == "NodePool":
                row += [_q(o.status.resources), o.status.node_count, _conds(o.status.conditions)]
            elif kind == "NodeClaim":
                s = o.status
                row += [s.provider_id, s.node_name, _q(s.capacity), _q(s.allocatable), _conds(s.conditions),
                        s.last_pod_event_time - t0]
            elif kind == "Node":
                row += [_q(o.status.capacity), _q(o.status.allocatable), _conds(o.status.conditions)]
            else:
                row += [repr(o.status), m.uid]
            rows.append(row)
        out[kind] = rows
    return out


@pytest.mark.parametrize("hetero", [False, True])
def test_fleet_builder_matches_the_operator_built_fleet(hetero):
    env = reference_fleet(7, hetero)
    fleet = build_consolidation_fleet(7, hetero_prices=hetero)
    t0 = 1_000_000.0
    assert canonical_fleet(fleet.store, t0) == canonical_fleet(env.store, t0)
    assert fleet.clock.now() == env.clock.now()
    assert [sn.name() for sn in fleet.cluster.nodes_view()] == [sn.name() for sn in env.cluster.nodes_view()]
    assert fleet.cluster.synced() and not fleet.cluster.consolidated()


# -- the round --------------------------------------------------------------------


def reference_side(n: int):
    """The reference's Environment-built fleet with its provisioner and
    disruption controller wired directly on its store and cluster."""
    from karpenter_tpu.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu.controllers.disruption.controller import DisruptionController
    from karpenter_tpu.controllers.provisioning.provisioner import Provisioner
    from karpenter_tpu.operator.options import Options
    from karpenter_tpu.solver.tpu import TPUSolver

    env = reference_fleet(n)
    cloud = FakeCloudProvider(env.cloud_provider.get_instance_types(None))
    prov = Provisioner(env.store, env.cluster, cloud, env.clock, solver=TPUSolver(recover=False))
    dc = DisruptionController(env.store, env.cluster, prov, cloud, env.clock, Options(solver_backend="tpu"))
    return SimpleNamespace(store=env.store, clock=env.clock, prov=prov, dc=dc, port=False)


def port_side(n: int, device="cpu"):
    from karpenter_tpu_torch.controllers.disruption.controller import DisruptionController
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    fleet = build_consolidation_fleet(n)
    prov = Provisioner(fleet.store, fleet.cluster, fleet.cloud_provider, fleet.clock, solver=GPUSolver(device=device))
    dc = DisruptionController(fleet.store, fleet.cluster, prov, fleet.cloud_provider, fleet.clock, Options())
    return SimpleNamespace(store=fleet.store, clock=fleet.clock, prov=prov, dc=dc, port=True)


def round_counters(registry, metrics) -> dict:
    """The LP round's counters: the proposal batch, the Adam steps, the
    exact validations by decision, the savings gauge."""
    return dict(proposals=registry.counter(metrics.SOLVER_CONSOLIDATION_PROPOSALS_TOTAL).value(proposer="lp"),
                lp_iterations=registry.counter(metrics.SOLVER_CONSOLIDATION_LP_ITERATIONS_TOTAL).total(),
                accepted=registry.counter(metrics.SOLVER_CONSOLIDATION_VALIDATION_TOTAL).value(decision="accept"),
                rejected=registry.counter(metrics.SOLVER_CONSOLIDATION_VALIDATION_TOTAL).value(decision="reject"),
                savings_per_hour=registry.gauge(metrics.SOLVER_CONSOLIDATION_SAVINGS_PER_HOUR).value(proposer="lp"))


def lp_decision(side) -> dict:
    """One LP decision over every candidate in the controller's order, with
    a metrics registry for the round (its counters recorded)."""
    mod = "karpenter_tpu_torch" if side.port else "karpenter_tpu"
    methods = __import__(f"{mod}.controllers.disruption.methods", fromlist=["MultiNodeConsolidation"])
    metrics = __import__(f"{mod}.metrics", fromlist=["make_registry"])
    ctx = side.dc.ctx
    cands = side.dc.get_candidates()
    ctx.round_candidates = cands
    ctx.node_pool_totals = None
    ctx.metrics = metrics.make_registry()
    try:
        m = methods.MultiNodeConsolidation(ctx)
        cmd = m._lp_option(cands, side.clock.now() + 1e9)
        counters = round_counters(ctx.metrics, metrics)
    finally:
        ctx.metrics = None
    if side.port:
        probes = (m.last_round["sim_masked"], m.last_round["sim_scratch"])
    else:
        trace = next(t for t in reversed(side.prov.solver.recorder.traces()) if t.mode == "consolidate")
        probes = (trace.attribution["sim_masked"], trace.attribution["sim_scratch"])
    return dict(n_candidates=len(cands), command=json_form(canonical_command(cmd)), probes=list(probes),
                counters=counters)


def disruption_pass(side) -> dict:
    """One `reconcile(force=True)`: the command it started, the disrupted
    taints it set, the NodeClaims in the store, how far the clock moved."""
    t0 = side.clock.now()
    side.dc.reconcile(force=True)
    items = side.dc.queue._items
    tainted = sorted(n.metadata.name for n in side.store.list("Node")
                     if any(t.key.endswith("disrupted") for t in n.spec.taints))
    return dict(commands=[json_form(canonical_command(it.command)) for it in items], tainted=tainted,
                claims=json_form(canonical_node_claims(side.store)), waited=side.clock.now() - t0)


def round_of(side, start: int) -> dict:
    same_state(start)
    random.seed(ROUND_SEED)
    clear_globals()
    out = dict(decision=lp_decision(side))
    same_state(start)
    random.seed(ROUND_SEED)
    clear_globals()
    out["pass"] = disruption_pass(side)
    return out


def test_round_matches_reference_small():
    start = next_start()
    want = round_of(reference_side(8), start)
    got = round_of(port_side(8), start)
    assert want["decision"]["command"][1], "the reference consolidates nothing"
    assert got == want


def test_fleet_5000_round_matches_fixture():
    """The port's 5000-node round on the CPU (the plain versions) against the
    reference's, stored."""
    want = json.loads(FIXTURE.read_text())
    got = round_of(port_side(FLEET_NODES), next_start())
    assert got["decision"] == want["decision"]
    assert got["pass"] == want["pass"]


def write_fixture() -> None:
    jsm.reset_bucket_highwater()
    out = round_of(reference_side(FLEET_NODES), next_start())
    FIXTURE.write_text(json.dumps(out, sort_keys=True) + "\n")
    cmd = out["decision"]["command"]
    print(f"wrote {FIXTURE}: {len(cmd[1])} of {out['decision']['n_candidates']} candidates, "
          f"probes {out['decision']['probes']}, pass {[len(c[1]) for c in out['pass']['commands']]}")


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_fixture()
    else:
        print(__doc__)
