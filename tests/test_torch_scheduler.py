"""The port's host scheduler (`karpenter_tpu_torch.solver.ffd.FFDSolver`)
against the reference's, on the CPU.

Each scenario builds a reference `SolverSnapshot` with the reference's own
builders (`bench.build_snapshot` at 300 pods x 20 instance types, plain and
with its affinity, PVC, fallback and minValues options; the test suite's
topology-spread, anti-affinity, host-port, existing-node, daemonset and
reserved-capacity shapes; the small provisioning corpus of
`tests/test_torch_fixtures.py`), carries it over into the port's classes
with `testing.carry_over.snapshot_from_reference` (every name, uid and
timestamp kept) and solves both. The `Results` must be equal in canonical
form: per new claim its nodepool, its sorted pod keys and its sorted
instance-type names; per existing node its sorted pod keys; every pod error,
key and message. Tolerance: exact.

The port's scheduler runs the signature-batched arm here (the reference's
default; `tests/test_torch_switches.py` runs these scenarios with
`KARPENTER_FFD_BATCH=0`, the unbatched arm, against the reference's). With
the DynamicResources gate on, the scheduler builds the port's DRA allocator
(`tests/test_torch_dra.py` holds its cases); a metrics registry on the
snapshot counts as the reference's does.
"""

from __future__ import annotations

import itertools
import random

import pytest

import bench
from helpers import hostname_anti_affinity, make_nodepool, make_pod, zone_spread
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.cloudprovider import catalog
from karpenter_tpu.controllers.provisioning.scheduling import nodeclaim as ref_nodeclaim
from karpenter_tpu.kube.objects import PodAffinityTerm
from karpenter_tpu.solver.ffd import FFDSolver as RefFFDSolver
from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.solver.ffd import FFDSolver
from karpenter_tpu_torch.solver.snapshot import SolverSnapshot as PortSnapshot
from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference
from test_domain_topology import make_snapshot, spread
from test_pod_affinity_tpu import existing_cluster, snapshot_of
from test_torch_fixtures import CORPUS

ZONE = wk.ZONE_LABEL_KEY
HOST = wk.HOSTNAME_LABEL_KEY


def _sel(**kv):
    return {"matchLabels": dict(kv)}


def _ported(pod, port=8080):
    pod.spec.containers[0].ports = [{"containerPort": port, "hostPort": port, "protocol": "TCP"}]
    return pod


def _topology_spread():
    """zone spread (maxSkew 1 and 2, minDomains), hostname spread and a
    ScheduleAnyway spread."""
    pods = [make_pod(cpu="1", labels={"app": "w"}, tsc=[zone_spread(1, _sel(app="w"))]) for _ in range(12)]
    pods += [make_pod(cpu="500m", labels={"app": "m"}, tsc=[spread(ZONE, 2, _sel(app="m"), min_domains=3)]) for _ in range(7)]
    pods += [make_pod(cpu="750m", labels={"app": "h"}, tsc=[spread(HOST, 1, _sel(app="h"))]) for _ in range(5)]
    pods += [make_pod(cpu="250m", labels={"app": "a"}, tsc=[zone_spread(1, _sel(app="a"), when="ScheduleAnyway")])
             for _ in range(6)]
    return make_snapshot(pods)


def _anti_affinity():
    """hostname and zone anti-affinity, required zone affinity."""
    pods = [make_pod(cpu="500m", labels={"app": "db"}, anti_affinity=[hostname_anti_affinity(_sel(app="db"))])
            for _ in range(6)]
    pods += [make_pod(cpu="1", labels={"app": "z"}, anti_affinity=[PodAffinityTerm(label_selector=_sel(app="z"),
                                                                                     topology_key=ZONE)])
             for _ in range(4)]
    pods += [make_pod(cpu="250m", labels={"aff": "g"},
                      pod_affinity=[PodAffinityTerm(label_selector=_sel(aff="g"), topology_key=ZONE)]) for _ in range(5)]
    pods += [make_pod(cpu="2") for _ in range(4)]
    return make_snapshot(pods)


def _host_ports():
    """host-ported replicas (one per node) beside plain pods, and a
    daemonset holding a port."""
    pods = [_ported(make_pod(cpu="500m")) for _ in range(5)]
    pods += [_ported(make_pod(cpu="250m"), port=9090) for _ in range(3)]
    pods += [make_pod(cpu="1") for _ in range(6)]
    snap = make_snapshot(pods)
    snap.daemonset_pods = [_ported(make_pod(cpu="100m", name="daemon-ported"), port=7070)]
    return snap


def _existing_nodes():
    """existing nodes of three zones, with running pods (one host-ported),
    pending pods that fit on them and pods that need new nodes."""
    nodes = (("na", "test-zone-a"), ("nb", "test-zone-b"), ("nc", "test-zone-c"))
    store, clock, cluster, np_ = existing_cluster(nodes=nodes, node_cpu="8")
    holder = _ported(make_pod(cpu="100m", name="port-holder"))
    holder.spec.node_name = "nb"
    store.create(holder)
    runner = make_pod(cpu="3", name="runner", labels={"app": "run"})
    runner.spec.node_name = "na"
    store.create(runner)
    pending = [make_pod(cpu="1", labels={"app": "web"}, tsc=[zone_spread(1, _sel(app="web"))]) for _ in range(9)]
    pending += [_ported(make_pod(cpu="500m")) for _ in range(4)]
    pending += [make_pod(cpu="6") for _ in range(3)]
    pending += [make_pod(cpu="1", node_selector={HOST: "nc"}) for _ in range(2)]
    return snapshot_of(store, clock, cluster, np_, pending)


def _daemonsets():
    """daemonsets with overhead, one pinned to a zone by node selector."""
    pods = [make_pod(cpu=c, memory="1Gi") for c in ("250m", "1", "2", "3") * 5]
    snap = make_snapshot(pods)
    snap.daemonset_pods = [make_pod(cpu="300m", memory="256Mi", name="ds-all"),
                           make_pod(cpu="200m", name="ds-zone-a", node_selector={ZONE: "test-zone-a"})]
    return snap


def _reserved():
    """reserved offerings beside on-demand and spot (the reservation
    manager's path)."""
    pools = [make_nodepool(requirements=[
        {"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In",
         "values": [wk.CAPACITY_TYPE_ON_DEMAND, wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_RESERVED]},
    ])]
    pods = [make_pod(cpu=c) for c in ("500m", "1", "2", "4") * 6]
    return make_snapshot(pods, node_pools=pools, types=catalog.construct_instance_types(include_reserved=True))


def _bench(**kw):
    return lambda: bench.build_snapshot(300, 20, **kw)


SCENARIOS = {
    "bench_plain": _bench(),
    "bench_affinity": _bench(affinity_frac=0.1),
    "bench_pvc": _bench(pvc_frac=0.1),
    "bench_fallback": _bench(fallback_frac=0.1),
    "bench_min_values": _bench(min_values=3),
    "topology_spread": _topology_spread,
    "anti_affinity": _anti_affinity,
    "host_ports": _host_ports,
    "existing_nodes": _existing_nodes,
    "daemonsets": _daemonsets,
    "reserved": _reserved,
    **{name: CORPUS[name] for name in sorted(CORPUS) if name.startswith("small_")},
}


def canonical(results) -> tuple:
    """Results as plain data: claims (nodepool, pod keys, instance types),
    existing nodes' pods, pod errors."""
    claims = sorted((nc.nodepool_name, tuple(sorted(p.key() for p in nc.pods)),
                     tuple(sorted(it.name for it in nc.instance_type_options)))
                    for nc in results.new_node_claims)
    existing = sorted((en.name(), tuple(sorted(p.key() for p in en.pods))) for en in results.existing_nodes)
    return claims, existing, sorted(results.pod_errors.items())


def same_scheduler_state(start: int) -> None:
    """Each package numbers its claims' hostname placeholders (which pod
    errors name) from a module counter: start both at `start`, past every
    number either has handed out, so placeholders stay unique."""
    random.seed(0)
    ref_nodeclaim._hostname_seq = itertools.count(start)
    port_nodeclaim._hostname_seq = itertools.count(start)


def solve_both(ref_snap):
    port_snap = snapshot_from_reference(ref_snap)
    start = max(next(ref_nodeclaim._hostname_seq), next(port_nodeclaim._hostname_seq))
    same_scheduler_state(start)
    want = canonical(RefFFDSolver().solve(ref_snap))
    same_scheduler_state(start)
    got = canonical(FFDSolver().solve(port_snap))
    return want, got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ffd_matches_reference(name):
    want, got = solve_both(SCENARIOS[name]())
    assert got == want
    assert want[0] or want[1], "the scenario placed nothing"


def test_carry_over_keeps_identity():
    """Names, uids, timestamps and resource versions survive the carry-over;
    one instance-type list shared by two nodepools stays one list."""
    ref = make_snapshot([make_pod(cpu="1") for _ in range(3)],
                        node_pools=[make_nodepool(name="a"), make_nodepool(name="b")])
    port = snapshot_from_reference(ref)
    assert isinstance(port, PortSnapshot)
    assert [(p.metadata.name, p.metadata.uid, p.metadata.creation_timestamp) for p in port.pods] == \
        [(p.metadata.name, p.metadata.uid, p.metadata.creation_timestamp) for p in ref.pods]
    assert port.instance_types["a"] is port.instance_types["b"]
    got = {(o.kind, o.metadata.name, o.metadata.resource_version) for o in port.store.borrow_list("NodePool")}
    assert got == {(o.kind, o.metadata.name, o.metadata.resource_version) for o in ref.store.borrow_list("NodePool")}
    assert type(port.pods[0]).__module__.startswith("karpenter_tpu_torch.")


def test_unported_paths_raise():
    """With the DynamicResources gate on, the solve equals the reference's
    (it raised `NotImplementedError` before the allocator was ported); a
    metrics registry on the snapshot counts the FFD's memo and phases as
    the reference's does (exact, the phase histograms by their counts)."""
    from karpenter_tpu.metrics import make_registry
    from test_torch_metrics import assert_same_registry, fresh_default_recorders

    dra = make_snapshot([make_pod(cpu="1")])
    dra.dra_enabled = True
    want, got = solve_both(dra)
    assert got == want and want[0]
    ref = make_snapshot([make_pod(cpu="1", name=f"m{i}") for i in range(6)])
    ref.registry = make_registry()
    port = snapshot_from_reference(ref)
    fresh_default_recorders()
    assert port.registry is not None and port.registry is not ref.registry
    start = max(next(ref_nodeclaim._hostname_seq), next(port_nodeclaim._hostname_seq))
    same_scheduler_state(start)
    want = canonical(RefFFDSolver().solve(ref))
    same_scheduler_state(start)
    assert canonical(FFDSolver().solve(port)) == want
    assert_same_registry(port.registry, ref.registry, "ffd")
    assert port.registry.counter("karpenter_solver_ffd_memo_total").total() > 0
