"""The decode's own shapes through `GPUSolver.solve`, on the CPU.

Against the reference's `TPUSolver(recover=False)`, with the
comparison of `tests/test_torch_solve.py` (canonical `Results`, mode,
backend, fallback reasons and delta-reject reason, exact), a cold solve and
an identical resubmit each:

- minValues (`tests/test_minvalues_tensor.py`'s shapes): a zone minValues
  met by widening the decode's domain pin, a zone minValues whose pin a
  spread holds (the bounded host repair), BestEffort relaxation, a Strict
  bound no instance type set can meet (every pod repaired to the host's
  errors), and randomized pods under an instance-type minValues;
- reserved capacity (`tests/test_reservations.py:147-189`): one reservation
  unit for two claims (the decode's reservation cap), and the strict
  reserved-offering mode (a fallback reason);
- PVC-backed volumes (`tests/test_volumes_tpu.py:135-234`): a
  WaitForFirstConsumer zone folded into the claim, a bound PV's single
  term, a local PV whose alternatives never constrain, CSI attach limits on
  an existing node, and no limit.

And the port on its own:

- the resident carry: dropped after a minValues repair
  (`test_repair_clears_resident_carry`), untouched after a `DecodeError`
  (with `force=True` it raises, without it the host FFD answers), on both
  packages alike; and no chain of earlier problems held by the resident
  problem after delta solves and resubmits;
- the decode memo (`tests/test_decode_delta.py:83-212`): chains of pod
  removals and additions solved by two port solvers over one snapshot, one
  with its memo cleared before every decode, give equal `Results` and
  modes; reused claims are fresh objects each solve, and corrupting an
  emitted claim cannot leak into the next solve's reused slots.
"""

from __future__ import annotations

import gc
import itertools
import random
import weakref

import pytest
import torch

from helpers import hostname_anti_affinity, make_pod, zone_spread
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.cloudprovider import catalog
from karpenter_tpu.solver.tpu import TPUSolver
from karpenter_tpu_torch.controllers.provisioning.scheduling import nodeclaim as port_nodeclaim
from karpenter_tpu_torch.solver.gpu import DecodeError, GPUSolver
from karpenter_tpu_torch.testing.canonical import canonical_results
from karpenter_tpu_torch.testing.carry_over import SnapshotMirror, snapshot_from_reference
from test_minvalues_tensor import minvalues_pool, random_pods
from test_reservations import reserved_types, two_big_pods_snapshot
from test_solver import make_snapshot
from test_torch_solve import _fresh_state  # noqa: F401 (autouse)
from test_torch_solve import assert_same, clear_globals, pinned_reserved as _pinned_reserved, run_scenario, solve_pair
import test_volumes_tpu as vol

torch.set_num_threads(1)

ZONE = wk.ZONE_LABEL_KEY
N_TYPES = len(catalog.construct_instance_types())


def _pods(n, **kw):
    return [make_pod(name=f"p{i}", **kw) for i in range(n)]


def _zone_widen():
    return make_snapshot(_pods(8, cpu="1"), node_pools=[minvalues_pool(key=ZONE, operator="Exists", mv=2)])


def _zone_spread_repair():
    sel = {"matchLabels": {"app": "w"}}
    pods = [make_pod(cpu="1", name=f"s{i}", labels={"app": "w"}, tsc=[zone_spread(selector=sel)]) for i in range(6)]
    return make_snapshot(pods, node_pools=[minvalues_pool(key=ZONE, operator="Exists", mv=2)])


def _best_effort():
    snap = make_snapshot(_pods(6, cpu="1"), node_pools=[minvalues_pool(mv=N_TYPES + 50)])
    snap.min_values_policy = "BestEffort"
    return snap


def _strict_unsatisfiable():
    return make_snapshot(_pods(4, cpu="1"), node_pools=[minvalues_pool(mv=N_TYPES + 50)])


def _random_min_values(seed):
    def build():
        rng = random.Random(seed)
        mv, n = rng.choice([2, 3, 4]), rng.randrange(20, 60)
        return make_snapshot(random_pods(random.Random(seed), n), node_pools=[minvalues_pool(mv=mv)])
    return build


def _reservation_cap():
    return two_big_pods_snapshot(reserved_types(reserved_capacity=1))


def _reservation_strict():
    return two_big_pods_snapshot(reserved_types(reserved_capacity=1), reserved_offering_mode="strict")


def _wffc_zone():
    pods = [make_pod(cpu="1", name=f"p{i}", volumes=[vol.pvc_volume(f"c{i}")]) for i in range(4)]
    return vol.make_snapshot(pods, lambda s: vol.seed_wffc(s, claims=[f"c{i}" for i in range(4)]))


def _prep_pv(store, local: bool) -> None:
    """A bound PV pinned to zone c; a local one also offers a hostname-only
    alternative, which leaves it unconstrained."""
    from karpenter_tpu.kube import ObjectMeta
    from karpenter_tpu.kube.objects import PersistentVolume, PersistentVolumeClaim
    from karpenter_tpu.scheduling.volumeusage import BIND_COMPLETED_ANNOTATION

    terms = [[{"key": ZONE, "operator": "In", "values": ["test-zone-c"]}]]
    if local:
        terms.append([{"key": wk.HOSTNAME_LABEL_KEY, "operator": "In", "values": ["old-node"]}])
    store.create(PersistentVolume(metadata=ObjectMeta(name="pv0"), csi_driver=vol.CSI, local=local,
                                  node_affinity_required=terms))
    store.create(PersistentVolumeClaim(metadata=ObjectMeta(name="c0", annotations={BIND_COMPLETED_ANNOTATION: "yes"}),
                                       volume_name="pv0", phase="Bound"))


def _pv(local):
    def build():
        return vol.make_snapshot([make_pod(cpu="1", volumes=[vol.pvc_volume("c0")])], lambda s: _prep_pv(s, local))
    return build


def _attach(limit):
    def build():
        pods = [make_pod(cpu="100m", name=f"p{i}", volumes=[vol.pvc_volume(f"c{i}")]) for i in range(4)]
        return vol.make_snapshot(pods, lambda s: vol.seed_wffc(s, claims=[f"c{i}" for i in range(4)], topologies=False),
                                 with_node=True, node_limit=limit)
    return build


SHAPES = {
    "min_values_zone_widen": _zone_widen,
    "min_values_zone_spread_repair": _zone_spread_repair,
    "min_values_best_effort": _best_effort,
    "min_values_strict_unsatisfiable": _strict_unsatisfiable,
    **{f"min_values_random_{seed}": _random_min_values(seed) for seed in range(3)},
    "reservation_cap": _reservation_cap,
    "reservation_strict": _reservation_strict,
    "volumes_wffc_zone": _wffc_zone,
    "volumes_bound_pv": _pv(local=False),
    "volumes_local_pv_mixed": _pv(local=True),
    "volumes_attach_limit": _attach(2),
    "volumes_no_limit": _attach(None),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shape_matches_reference(name):
    run_scenario(SHAPES[name], name)


def test_shapes_reach_their_paths():
    """The shapes take the paths they are here for: a widened pin, a repair,
    a relaxed bound, a reservation pinned and one refused, a fallback."""
    from karpenter_tpu_torch.apis import labels as pwk

    def solve(name):
        gpu = GPUSolver(device="cpu")
        return gpu, gpu.solve(snapshot_from_reference(SHAPES[name]()))

    gpu, res = solve("min_values_zone_widen")
    assert gpu.last_backend == "gpu" and not res.pod_errors
    assert all(len(nc.requirements.get(pwk.ZONE_LABEL_KEY).values_list()) != 1 for nc in res.new_node_claims)
    gpu, res = solve("min_values_strict_unsatisfiable")
    assert gpu.last_decode.get("repair_pods") == 4 and all("minValues" in e for e in res.pod_errors.values())
    gpu, res = solve("min_values_best_effort")
    assert all(nc.requirements.get(pwk.INSTANCE_TYPE_LABEL_KEY).min_values <= len(nc.instance_type_options)
               for nc in res.new_node_claims)
    gpu, res = solve("reservation_cap")
    caps = sorted(_pinned_reserved(nc) for nc in res.new_node_claims)
    assert caps == [False, True]
    gpu, _ = solve("reservation_strict")
    assert gpu.last_backend == "ffd-fallback" and "strict reserved-offering" in " ".join(gpu.last_fallback_reasons)
    assert gpu.last_fallback_family == "strict-reserved-offering"


# -- the resident carry ------------------------------------------------------------

def test_repair_clears_resident_carry():
    """A solve whose decode repaired minValues on the host leaves no
    resident carry (the reference drops it too); the next clean solve packs
    in full and succeeds."""
    ref_solver, gpu = TPUSolver(recover=False), GPUSolver(device="cpu")
    first = _strict_unsatisfiable()
    port_first = snapshot_from_reference(first)
    clear_globals()
    want, got = solve_pair(ref_solver, gpu, first, port_first)
    assert_same(want, got, "repair")
    assert gpu.last_decode.get("repair_pods") == 4
    assert ref_solver._resident is None and gpu._resident is None
    clean = make_snapshot([make_pod(cpu="1", name="ok")])
    want, got = solve_pair(ref_solver, gpu, clean, snapshot_from_reference(clean))
    assert_same(want, got, "after the repair")
    assert got["mode"] == "full" and not got["results"][2]


def _break_template_ctx(monkeypatch, cls):
    """Every instance type's daemon-overhead group emptied in the decode's
    fits context: no slot's packed row is launchable, so decode raises."""
    real = cls._template_ctx

    def broken(template, groups, enc, cache):
        its, alloc, _ginfo, ov = real(template, groups, enc, cache)
        return its, alloc, [], ov

    monkeypatch.setattr(cls, "_template_ctx", staticmethod(broken))


@pytest.mark.parametrize("force", [True, False])
def test_decode_error_leaves_resident_carry(force, monkeypatch):
    """A `DecodeError` on a delta solve leaves the resident carry of the
    solve before it untouched, on both packages: with `force=True` the
    error propagates, without it the host FFD answers."""
    ref_snap = make_snapshot(_pods(10, cpu="500m"))
    port_snap = snapshot_from_reference(ref_snap)
    ref_solver = TPUSolver(force=force, recover=False)
    gpu = GPUSolver(device="cpu", force=force)
    clear_globals()
    solve_pair(ref_solver, gpu, ref_snap, port_snap)
    kept_ref, kept_port = ref_solver._resident, gpu._resident
    assert kept_ref is not None and kept_port is not None
    _break_template_ctx(monkeypatch, TPUSolver)
    _break_template_ctx(monkeypatch, GPUSolver)
    added = make_pod(cpu="500m", name="late")
    ref_snap.pods.append(added)
    port_snap.pods.append(snapshot_from_reference(make_snapshot([added])).pods[0])
    if force:
        with pytest.raises(DecodeError):
            gpu.solve(port_snap)
        from karpenter_tpu.solver.tpu import DecodeError as RefDecodeError

        with pytest.raises(RefDecodeError):
            ref_solver.solve(ref_snap)
    else:
        want, got = solve_pair(ref_solver, gpu, ref_snap, port_snap)
        assert_same(want, got, "decode error")
        assert got["mode"] == "fallback" and got["reasons"][0].startswith("validation: slot ")
        assert gpu.last_fallback_family == "validation"
    assert ref_solver._resident is kept_ref and gpu._resident is kept_port


def test_delta_solves_keep_no_problem_chain():
    """Delta solves and identical resubmits through `solve` keep no link
    from the resident problem to the problems before it: the resident
    problem has no delta, and the first solve's problem is freed."""
    ref_snap = make_snapshot(_pods(10, cpu="500m"))
    port_snap = snapshot_from_reference(ref_snap)
    gpu = GPUSolver(device="cpu")
    clear_globals()
    gpu.solve(port_snap)
    first = weakref.ref(gpu._resident["problem"])
    modes = []
    for i in range(3):
        if i < 2:
            port_snap.pods.append(snapshot_from_reference(make_snapshot([make_pod(cpu="500m", name=f"late-{i}")])).pods[0])
        gpu.solve(port_snap)
        modes.append(gpu.last_solve_mode)
        assert gpu._resident["problem"].delta is None
    assert modes == ["delta"] * 3
    gc.collect()
    assert first() is None


# -- the decode memo ---------------------------------------------------------------

class ChainPair:
    """Two port solvers over one reference snapshot, carried over step by
    step: `memo` keeps its decode memo, `plain` has it cleared before every
    decode (every slot materialised again)."""

    def __init__(self, ref_snap):
        self.ref = ref_snap
        self.mirror = SnapshotMirror()
        self.memo, self.plain = GPUSolver(device="cpu", force=True), GPUSolver(device="cpu", force=True)
        self.modes: list = []

    def step(self, what: str):
        snap = self.mirror.snapshot(self.ref)
        port_nodeclaim._hostname_seq = itertools.count(1)
        got = self.memo.solve(snap)
        self.plain._decode_memo = None
        port_nodeclaim._hostname_seq = itertools.count(1)
        want = self.plain.solve(snap)
        assert self.memo.last_solve_mode == self.plain.last_solve_mode, what
        assert canonical_results(got) == canonical_results(want), what
        self.modes.append((self.memo.last_solve_mode, self.memo.last_decode.get("mode")))
        return got


def _mutate(rng, snap, step):
    """One churn step: removals and/or uniquely-named additions (the
    reference's `tests/test_decode_delta.py` recipe)."""
    op = rng.random()
    if op < 0.4 and len(snap.pods) > 4:
        for _ in range(rng.randrange(1, 4)):
            snap.pods.pop(rng.randrange(len(snap.pods)))
    elif op < 0.7:
        snap.pods.extend(make_pod(cpu=rng.choice(["250m", "500m", "1"]), name=f"add{step}-{i}") for i in range(rng.randrange(1, 4)))
    else:
        snap.pods.pop(rng.randrange(len(snap.pods)))
        snap.pods.append(make_pod(cpu="500m", name=f"swap{step}"))


def _multi_slot_pods(prefix, n_spread=8, n_fill=6):
    """A hostname anti-affinity group (one slot each) beside small fillers
    that share one slot."""
    sel = {"matchLabels": {"app": f"{prefix}-spread"}}
    return [
        make_pod(cpu="1", name=f"{prefix}{i}", labels={"app": f"{prefix}-spread"}, anti_affinity=[hostname_anti_affinity(sel)])
        for i in range(n_spread)
    ] + [make_pod(cpu="250m", name=f"{prefix}-fill{i}") for i in range(n_fill)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_memo_randomized_chain(seed):
    rng = random.Random(seed)
    pair = ChainPair(make_snapshot(random_pods(rng, 24)))
    pair.step("warmup")
    for step in range(5):
        _mutate(rng, pair.ref, step)
        pair.step(f"step {step}")
    assert pair.modes[0] == ("full", "full")
    assert any(m == "delta" for m, _ in pair.modes[1:])


def test_decode_memo_anti_affinity_chain():
    sel = {"matchLabels": {"app": "aa"}}
    pods = [make_pod(cpu="500m", name=f"aa{i}", labels={"app": "aa"}, anti_affinity=[hostname_anti_affinity(sel)])
            for i in range(6)] + [make_pod(cpu="250m", name=f"fill{i}") for i in range(10)]
    pair = ChainPair(make_snapshot(pods))
    pair.step("warmup")
    pair.ref.pods.pop(2)  # an anti-affinity member leaves
    pair.step("remove-anti")
    pair.ref.pods.append(make_pod(cpu="500m", name="aa9", labels={"app": "aa"}, anti_affinity=[hostname_anti_affinity(sel)]))
    pair.step("add-anti")
    assert ("delta", "delta-reuse") in pair.modes


def test_decode_memo_host_port_chain():
    pods = [make_pod(cpu="250m", name=f"pp{i}") for i in range(10)]
    for i in (0, 1):
        pods[i].spec.containers[0].ports = [{"containerPort": 8080, "hostPort": 8080, "protocol": "TCP"}]
    pair = ChainPair(make_snapshot(pods))
    pair.step("warmup")
    pair.ref.pods.pop()
    pair.step("remove")
    ported = make_pod(cpu="250m", name="pp-late")
    ported.spec.containers[0].ports = [{"containerPort": 8080, "hostPort": 8080, "protocol": "TCP"}]
    pair.ref.pods.append(ported)
    pair.step("add-ported")
    pair.ref.pods.append(make_pod(cpu="250m", name="pp-after"))
    pair.step("after")


def test_decode_memo_min_values_chain():
    pair = ChainPair(make_snapshot([make_pod(cpu="500m", name=f"mv{i}") for i in range(12)],
                                   node_pools=[minvalues_pool(mv=2)]))
    pair.step("warmup")
    for step in range(3):
        pair.ref.pods.pop(0)
        pair.ref.pods.append(make_pod(cpu="500m", name=f"mv-add{step}"))
        pair.step(f"step {step}")


def test_adopted_claim_mutation_cannot_leak_into_reuse():
    """Corrupting emitted claims between solves (pods, options, requests)
    cannot reach the next delta's reused slots."""
    pair = ChainPair(make_snapshot(_multi_slot_pods("m")))
    first = pair.step("warmup")
    victims = [nc for nc in first.new_node_claims if nc.pods]
    assert victims
    intruder = snapshot_from_reference(make_snapshot([make_pod(cpu="250m", name="intruder")])).pods[0]
    for nc in victims:
        nc.pods.append(intruder)
        nc.pods.pop(0)
        nc.instance_type_options = []
        nc.requests = {}
    pair.ref.pods.pop()
    second = pair.step("post-mutation")
    assert pair.memo.last_decode["mode"] == "delta-reuse" and pair.memo.last_decode["reused_slots"] >= 1
    assert all(p.metadata.name != "intruder" for nc in second.new_node_claims for p in nc.pods)


def test_reused_claims_are_fresh_objects_per_solve():
    """Two consecutive deltas never hand out the same claim object for a
    reused slot."""
    pair = ChainPair(make_snapshot(_multi_slot_pods("f")))
    pair.step("warmup")
    pair.ref.pods.pop()
    r1 = pair.step("delta 1")
    pair.ref.pods.pop()
    r2 = pair.step("delta 2")
    assert pair.memo.last_decode["mode"] == "delta-reuse"
    assert not {id(nc) for nc in r1.new_node_claims} & {id(nc) for nc in r2.new_node_claims}
