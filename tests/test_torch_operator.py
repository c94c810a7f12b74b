"""The port's operator (`karpenter_tpu_torch.operator`) against the
reference's, on the CPU.

A seeded scenario through both operators: `build_snapshot(200, 20)`'s
nodepool and instance types in an `Environment` (the KWOK provider behind
it), its pods created pending, uids from a generator seeded with
`SNAPSHOT_SEED`. The reference's `Environment(Options(solver_backend="tpu"))`
and the port's `Environment(Options(), device="cpu")` are ticked side by
side (`chip_smoke.OperatorWatch`: a 2 s clock step, `tick(provision_force=
True)`) until a tick changes nothing; then a seeded half of the pods is
deleted and both are ticked again until quiet, through consolidation (a
phase ends after `SCENARIO_QUIET` ticks in a row change nothing). Each
tick's canonical state (`testing.canonical.canonical_operator`: NodeClaims,
Nodes, each pod's node, events, counters), its solves (mode, backend,
pods, signatures, reasons, notes of each trace) and its disruption
commands must be equal; each tick's kernel calls must be those its solves
need (`chip_smoke.operator_launches`). Exact.

The port's default backend is "gpu", where the reference's is "ffd": the
one intended deviation of the operator, held by
`test_port_default_backend_is_gpu` (the twins of the reference's suites,
`test_torch_twins_*.py`, run the reference's default).

The card's fixture, `karpenter_tpu_torch/fixtures/operator/
headline_5000x100_ticks.json`, is the reference's `Environment(Options(
solver_backend="tpu"))` over the seeded headline (5000 pending pods, 100
types, not cut) for every tick until a tick changes nothing, at most 8:
per tick the digest of the canonical state and its summaries, the last
tick's state in full. `chip_smoke.check_operator` holds the port on the
card to it. Writing it takes several minutes on a CPU:

    JAX_PLATFORMS=cpu KARPENTER_SOLVER_BUCKET=0 python tests/test_torch_operator.py --write
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import helpers  # noqa: E402
from chip_smoke import (  # noqa: E402
    OPERATOR_FIXTURE,
    OPERATOR_MAX_TICKS,
    SNAPSHOT_SEED,
    SNAPSHOT_SHAPE,
    OperatorWatch,
    digest,
    kept_proposer_inputs,
    kept_snapshot_inputs,
    operator_env,
    operator_launches,
    operator_start,
    operator_ticks,
)
from karpenter_tpu.controllers.provisioning.scheduling import nodeclaim as ref_nodeclaim  # noqa: E402
from karpenter_tpu.models import scheduler_model as jsm  # noqa: E402
from karpenter_tpu.obs import trace as ref_trace  # noqa: E402
from karpenter_tpu.operator import Environment as RefEnvironment  # noqa: E402
from karpenter_tpu.operator.options import Options as RefOptions  # noqa: E402
from karpenter_tpu.solver.encode import clear_encode_globals as ref_clear_encode_globals  # noqa: E402
from karpenter_tpu_torch.operator import Environment  # noqa: E402
from karpenter_tpu_torch.operator.options import Options  # noqa: E402
from torch_operator_scenario import (  # noqa: E402
    SCENARIO,
    SCENARIO_MAX_TICKS,
    SCENARIO_QUIET,
    port_watch,
    remove_half,
    run_phases,
    seeded,
)

torch.set_num_threads(1)


def reference_watch(shape: tuple = SCENARIO) -> OperatorWatch:
    """The reference's arm: `Environment(Options(solver_backend="tpu"))`
    over the seeded snapshot (`bench.build_snapshot`), from fresh module
    state, watched."""
    ref_clear_encode_globals()
    jsm.reset_bucket_highwater()
    ref_trace._DEFAULT = ref_trace.TraceRecorder()
    snap = seeded(shape, bench.build_snapshot, helpers)
    watch = OperatorWatch(operator_env(snap, RefEnvironment, RefOptions(solver_backend="tpu")))
    operator_start(ref_nodeclaim)
    return watch


@pytest.fixture(scope="module")
def reference_run():
    return run_phases(reference_watch())


def test_seeded_scenario_matches_reference(reference_run):
    """Through provisioning, then consolidation after half the pods leave:
    every tick's canonical state, solves and disruption commands equal."""
    got = run_phases(port_watch())
    for k, (g, w) in enumerate(zip(got, reference_run)):
        assert len(g["records"]) == len(w["records"]), f"phase {k}: {len(g['records'])} ticks, the reference's {len(w['records'])}"
        for t, (gr, wr) in enumerate(zip(g["records"], w["records"])):
            for key in wr:
                assert gr[key] == wr[key], f"phase {k} tick {t}: {key} differs"
        assert g["state"] == w["state"]
    first, second = reference_run
    # the scenario reaches what it is for: every pod bound, then nodes consolidated away
    assert first["records"][-1]["bound"] == SCENARIO[0]
    assert second["records"][-1]["nodes"] < first["records"][-1]["nodes"]
    assert any(r["decisions"] for r in second["records"])
    assert {s["mode"] for r in first["records"] for s in r["solves"]} >= {"full"}
    assert any(s["mode"] == "consolidate" and "proposals" in s["notes"] for r in second["records"] for s in r["solves"])


def test_kernel_calls_follow_recorded_solves():
    """On the CPU the wrappers run their plain versions; each tick of the
    port's scenario calls K1-K3, K4, K5 and K6 exactly as often as its
    solves' traces say (`operator_launches`, which the card's phase holds
    the launch counts to)."""
    from karpenter_tpu_torch.testing.canonical import canonical_operator, json_form

    watch = port_watch()
    need_total = {}
    for phase in range(2):
        if phase:
            remove_half(watch.env)
        prev, still = json_form(canonical_operator(watch.env)), 0
        for _ in range(SCENARIO_MAX_TICKS):
            seen = {"pack": [], "rc": [], "k5": [], "k6": []}
            with kept_snapshot_inputs(seen), kept_proposer_inputs(seen):
                state, rec = watch.tick()
            need = operator_launches(rec["solves"])
            got = {"feasibility": len(seen["pack"]), "pack_scan": len(seen["pack"]), "sparsify": len(seen["pack"]),
                   "recredit": len(seen["rc"]), "globalpack": len(seen["k5"]), "score_subsets": len(seen["k6"])}
            assert {k: v for k, v in got.items() if v} == need, rec["solves"]
            for k, v in need.items():
                need_total[k] = need_total.get(k, 0) + v
            still = still + 1 if state == prev else 0
            if still == SCENARIO_QUIET:
                break
            prev = state
    assert need_total.get("pack_scan", 0) >= 2 and need_total.get("globalpack", 0) >= 1


def test_port_default_backend_is_gpu():
    """The one intended deviation: the port's default backend is "gpu" (its
    `GPUSolver`, on the card unless the CPU is named), the reference's
    "ffd". The reference's "tpu" is not a backend of the port."""
    from karpenter_tpu_torch.solver.ffd import FFDSolver
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    assert RefOptions().solver_backend == "ffd"
    assert Options().solver_backend == "gpu"
    assert Options.from_args([]).solver_backend == "gpu"
    assert any("solver-backend" in e for e in Options(solver_backend="tpu").validate())
    with pytest.raises(ValueError, match="solver-backend"):
        Options.from_args(["--solver-backend", "tpu"])
    env = Environment(device="cpu")
    assert isinstance(env.provisioner.solver, GPUSolver) and env.provisioner.solver.device.type == "cpu"
    assert env.provisioner.solver.registry is env.registry
    assert isinstance(Environment(Options(solver_backend="ffd"), device="cpu").provisioner.solver, FFDSolver)
    if torch.cuda.is_available():
        assert Environment().provisioner.solver.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Environment()


def test_server_router_and_tenants():
    """Serving's parts of the server: with a router (a stand-in with the
    `ShardRouter` surface) `/readyz`, `/metrics`, `/debug/tenants` and
    `/debug/shards` answer from it and `/debug/solves` proxies by
    `?tenant=` (400 without one, 404 for an unknown one); without one,
    `/debug/tenants` answers the reference's empty map of a process without
    a fleet front-end, and every live `FleetFrontend`'s tenants once one
    exists."""
    import urllib.error
    import urllib.request

    from karpenter_tpu_torch.operator.server import OperatorServer
    from karpenter_tpu_torch.serving.fleet import FleetFrontend, reset_tenant_labels

    class Router:
        def ready(self):
            return False

        def merged_metrics(self):
            return "karpenter_solver_fleet_shards 2\n"

        def debug_tenants(self):
            return {"t0": {"shard": "shard-0"}}

        def debug_shards(self):
            return {"shard-0": {"alive": True}, "shard-1": {"alive": False}}

        def debug_solves(self, tenant, n=None):
            if tenant != "t0":
                raise KeyError(tenant)
            return json.dumps({"solves": [], "n": n})

    def get(port, path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    server = OperatorServer(None, port=0, bind="127.0.0.1", router=Router())
    port = server.start()
    try:
        assert get(port, "/readyz")[0] == 503
        assert get(port, "/metrics") == (200, "karpenter_solver_fleet_shards 2\n")
        assert json.loads(get(port, "/debug/tenants")[1]) == {"tenants": {"t0": {"shard": "shard-0"}}}
        assert set(json.loads(get(port, "/debug/shards")[1])["shards"]) == {"shard-0", "shard-1"}
        assert json.loads(get(port, "/debug/solves?tenant=t0&n=2")[1]) == {"solves": [], "n": 2}
        assert get(port, "/debug/solves")[0] == 400 and get(port, "/debug/solves?tenant=x")[0] == 404
    finally:
        server.stop()
    server = OperatorServer(Environment(Options(solver_backend="ffd")), port=0, bind="127.0.0.1")
    port = server.start()
    reset_tenant_labels()
    try:
        assert json.loads(get(port, "/debug/tenants")[1]) == {"tenants": {}}
        body = json.loads(get(port, "/debug/solves?n=1")[1])
        assert len(body["solves"]) <= 1
        assert get(port, "/debug/shards")[0] == 404
        fleet = FleetFrontend(device="cpu")
        try:
            fleet.add_tenant("team-a", options=Options(solver_backend="ffd"))
            assert set(json.loads(get(port, "/debug/tenants")[1])["tenants"]) == {"team-a"}
        finally:
            fleet.close()
        assert json.loads(get(port, "/debug/tenants")[1]) == {"tenants": {}}
    finally:
        server.stop()
        reset_tenant_labels()


def test_carry_over_keeps_operator_objects():
    """A reference store holding a `KWOKNodeClass`, a `NodeOverlay` and the
    leader `Lease` carries over into the port's classes, with the
    reference's names, uids, resource versions and fields."""
    from karpenter_tpu.apis.kwoknodeclass import KWOKNodeClass
    from karpenter_tpu.apis.nodeoverlay import NodeOverlay
    from karpenter_tpu.kube import ObjectMeta, Store
    from karpenter_tpu.operator.leaderelection import LeaderElector
    from karpenter_tpu.solver.snapshot import SolverSnapshot
    from karpenter_tpu.utils.clock import FakeClock
    from karpenter_tpu.utils.quantity import Quantity
    from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference
    from test_torch_dra import plain

    clock = FakeClock()
    store = Store(clock=clock)
    store.create(KWOKNodeClass())
    overlay = NodeOverlay(metadata=ObjectMeta(name="cheap"))
    overlay.spec.weight = 5
    overlay.spec.price = "1.5"
    overlay.spec.capacity = {"example.com/gpu": Quantity.parse("2")}
    store.create(overlay)
    assert LeaderElector(store, clock, "a").try_acquire_or_renew()
    ref = SolverSnapshot(store=store, cluster=None, node_pools=[], instance_types={}, state_nodes=[],
                         daemonset_pods=[], pods=[], clock=clock)
    port = snapshot_from_reference(ref)
    for kind in ("KWOKNodeClass", "NodeOverlay", "Lease"):
        want, got = store.list(kind), port.store.list(kind)
        assert len(want) == 1 and [plain(o) for o in got] == [plain(o) for o in want], kind
        assert [(o.metadata.uid, o.metadata.resource_version) for o in got] == \
            [(o.metadata.uid, o.metadata.resource_version) for o in want], kind
        assert type(got[0]).__module__.startswith("karpenter_tpu_torch."), kind


def test_operator_fixture_is_whole():
    """The card's fixture: the seeded headline, at most `OPERATOR_MAX_TICKS`
    ticks ending on one that changes nothing (or the cap), every pod bound
    by its end, the last digest that of the stored final state, K1-K3 on
    its first tick, under 2 MB."""
    assert OPERATOR_FIXTURE.stat().st_size < 2 * 1024 * 1024
    want = json.loads(OPERATOR_FIXTURE.read_text())
    assert want["shape"] == list(SNAPSHOT_SHAPE) and want["seed"] == SNAPSHOT_SEED
    ticks = want["ticks"]
    assert 1 <= len(ticks) <= OPERATOR_MAX_TICKS
    assert not ticks[-1]["changed"] or len(ticks) == OPERATOR_MAX_TICKS
    assert ticks[-1]["digest"] == digest(want["final"])
    assert ticks[-1]["bound"] == SNAPSHOT_SHAPE[0] and ticks[0]["pods"] == SNAPSHOT_SHAPE[0]
    assert operator_launches(ticks[0]["solves"]).get("pack_scan", 0) >= 1


# -- the card's fixture ---------------------------------------------------------------
def write_operator_fixture() -> None:
    """The reference's ticks over the seeded headline (the module docstring)."""
    import time

    watch = reference_watch(SNAPSHOT_SHAPE)
    t0 = time.perf_counter()
    records, state = operator_ticks(watch, OPERATOR_MAX_TICKS)
    out = dict(seed=SNAPSHOT_SEED, shape=list(SNAPSHOT_SHAPE), ticks=records, final=state)
    OPERATOR_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    OPERATOR_FIXTURE.write_text(json.dumps(out, separators=(",", ":")))
    print(f"wrote {OPERATOR_FIXTURE} ({OPERATOR_FIXTURE.stat().st_size} bytes, {len(records)} ticks, "
          f"{time.perf_counter() - t0:.1f} s): "
          + "; ".join(f"claims {r['claims']} nodes {r['nodes']} bound {r['bound']} "
                      f"solves {[s['mode'] for s in r['solves']]} commands {len(r['decisions'])}" for r in records))


if __name__ == "__main__":
    if "--write" in sys.argv:
        write_operator_fixture()
    else:
        print(__doc__)
