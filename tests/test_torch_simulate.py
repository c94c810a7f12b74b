"""The port's consolidation simulator (`solver/simulate.py`: one round-base
encode, masked sub-encode probes packed by `GPUSolver.solve_prepared`)
against the reference's, on the CPU.

The cases of `tests/test_consolidation_lp.py` (:71-236), each cluster built
through the reference's Environment and wired in both packages by
`test_torch_disruption.Pair`: on the underutilized fleet, batches of
candidates probed through the simulator give the results of a from-scratch
`simulate_scheduling` (placements and instance types, the reference's own
`canon_results`) and the reference's masked results (exact), with the same
probe modes and counts; no masked result places a pod on a deleted node; a
masked probe leaves the provisioning solver's warm state (the resident
carry, the hybrid carry, the decode memo) and its encode cache as they were,
so resubmitting the provisioning snapshot still packs from that carry; a zone-spread
fleet and an anti-affinity fleet ride the masked path, a hostname-spread
fleet and the host FFD solver go from scratch, for the reference's reasons;
`solver/validate.validate_results` gives the reference's verdict.
Across the packages exact (`testing.canonical.canonical_results`).
"""

from __future__ import annotations

import random

import pytest
import torch

from helpers import hostname_anti_affinity, make_nodepool, make_pod, zone_spread
from karpenter_tpu.apis import labels as wk
from karpenter_tpu.apis.nodepool import Budget
from karpenter_tpu.operator import Environment
from karpenter_tpu.operator.options import Options
from karpenter_tpu_torch.testing.canonical import canonical_results
from test_consolidation_lp import canon_results
from test_torch_disruption import OD_ONLY, Pair, _fresh_state, fleet_env  # noqa: F401 (autouse)

torch.set_num_threads(1)


def simulator(side, trace=None):
    sim_mod = side.m("solver.simulate")
    cands = side.dc.get_candidates()
    if side.port:
        return sim_mod.ConsolidationSimulator(side.prov, side.cluster, side.clock, cands, trace=trace), cands
    return sim_mod.ConsolidationSimulator(side.prov, side.cluster, side.clock, cands), cands


def scratch(side, batch):
    helpers = side.m("controllers.disruption.helpers")
    return helpers.simulate_scheduling(side.prov, side.cluster, batch, side.clock)


def probe_batches(pair, batches, want_mode: str = "masked"):
    """Each batch (candidate indices) through the round's simulator and from
    scratch, on each side: (canonical results, mode) per batch and the probe
    counts must agree across the packages; within each, the probe must place
    as the from-scratch simulation does (the reference's contract)."""

    def run(side):
        sim, cands = simulator(side)
        out = []
        for idx in batches:
            batch = [cands[i] for i in idx]
            r = sim.simulate(batch)
            mode = sim.last_mode
            s = scratch(side, batch)
            assert canon_results(r) == canon_results(s), (idx, mode)
            out.append((canonical_results(r), mode))
        return out, sim.masked_probes, sim.scratch_probes, sim.why_scratch

    out, masked, scratch_n, why = pair.run(run)
    assert {m for _r, m in out} == {want_mode}, why
    return out, masked, scratch_n, why


@pytest.fixture(scope="module")
def fleet6():
    return fleet_env(6)


def flipped(env) -> Pair:
    pair = Pair(env)
    pair.flip()
    return pair


def test_batches_bit_identical_to_scratch(fleet6):
    pair = flipped(fleet6)
    rng = random.Random(7)
    batches = [[0, 1], [0, 1, 2, 3], list(range(6)), [1, 3, 5]]
    batches += [sorted(rng.sample(range(6), rng.randrange(2, 6))) for _ in range(4)]
    _out, masked, scratch_n, _why = probe_batches(pair, batches)
    assert (masked, scratch_n) == (len(batches), 0)


def test_masked_results_never_reference_deleted_nodes(fleet6):
    pair = flipped(fleet6)

    def run(side):
        sim, cands = simulator(side)
        batch = cands[:3]
        names = {c.name() for c in batch}
        r = sim.simulate(batch)
        assert sim.last_mode == "masked"
        assert not any(en.state_node.name() in names for en in r.existing_nodes)
        return canonical_results(r)

    pair.run(run)


def test_provisioning_warm_state_survives_a_round(fleet6):
    """A provisioning solve first (it keeps a resident carry), then a masked
    probe: the carry, hybrid state and decode memo are the same objects
    after it, and resubmitting the snapshot packs from that carry (mode
    "delta")."""
    pair = flipped(fleet6)

    def run(side):
        kube, res = side.m("kube.objects"), side.m("utils.resources")
        for i in range(3):
            side.store.create(kube.Pod(
                metadata=kube.ObjectMeta(name=f"pending-{i}", uid=f"pending-{i}-uid"),
                spec=kube.PodSpec(containers=[kube.Container(
                    resources={"requests": res.parse_resource_list({"cpu": "3"})})]),
            ))
        solver = side.prov.solver
        snap = side.prov.make_snapshot(side.prov.get_pending_pods())
        modes = [canonical_results(solver.solve(snap)), solver.last_solve_mode]
        before = (solver._resident, solver._hybrid_state, solver._decode_memo)
        cache = (solver.encode_cache.last_enc, solver.encode_cache.row_key)
        sim, cands = simulator(side)
        sim.simulate(cands[:3])
        assert sim.last_mode == "masked" and solver.last_solve_mode == "sim"
        assert solver._resident is before[0] and before[0] is not None
        assert solver._hybrid_state is before[1] and solver._decode_memo is before[2]
        assert (solver.encode_cache.last_enc, solver.encode_cache.row_key) == cache
        modes += [canonical_results(solver.solve(snap)), solver.last_solve_mode]
        return modes

    modes = pair.run(run)
    assert (modes[1], modes[3]) == ("full", "delta") and modes[0] == modes[2]


def test_encodecache_untouched_by_masked_probes(fleet6):
    pair = flipped(fleet6)

    def run(side):
        solver = side.prov.solver
        before = (solver.encode_cache.last_enc, solver.encode_cache.row_key)
        sim, cands = simulator(side)
        sim.simulate(cands[:2])
        assert sim.last_mode == "masked"
        assert (solver.encode_cache.last_enc, solver.encode_cache.row_key) == before
        return True

    pair.run(run)


def test_stages_split_the_probe():
    """The simulator's stages are spans on the round's trace; the masked
    probe's own solve is a trace of its own, mode "sim", with its pack."""
    from karpenter_tpu_torch.obs.trace import SolveTrace

    pair = flipped(fleet_env(4))
    round_trace = SolveTrace(enabled=True)
    sim, cands = simulator(pair.port, trace=round_trace)
    solver = pair.port.prov.solver
    solver.stage_times = True
    sim.simulate(cands[:2])
    assert {"sim base", "sim_mask_encode", "solve_prepared"} <= set(round_trace.phase_totals)
    assert solver.last_solve_mode == "sim" and "pack" in solver.last_stages


def _env_with_pool():
    env = Environment(options=Options(solver_backend="tpu"))
    np_ = make_nodepool(requirements=OD_ONLY)
    np_.spec.disruption.consolidate_after = "30s"
    np_.spec.disruption.budgets = [Budget(nodes="100%")]
    env.store.create(np_)
    return env


def _spread_env(host: bool):
    env = _env_with_pool()
    sel = {"matchLabels": {"app": "x"}}
    for i in range(4):
        env.store.create(
            make_pod(cpu="500m", name=f"s{i}", labels={"app": "x"}, anti_affinity=[hostname_anti_affinity(sel)]))
    env.settle()
    for i in range(4):
        env.store.delete("Pod", f"s{i}")
    tsc = zone_spread(selector={"matchLabels": {"app": "w"}})
    if host:
        tsc.topology_key = wk.HOSTNAME_LABEL_KEY
    for i in range(4):
        env.store.create(make_pod(cpu="250m", name=f"w{i}", labels={"app": "w"}, tsc=[tsc]))
    env.settle(rounds=4)
    return env


def test_spread_fleet_rides_masked_with_probe_counts():
    pair = flipped(_spread_env(host=False))

    def batches(side):
        cands = side.dc.get_candidates()
        withpods = [i for i, c in enumerate(cands) if c.reschedulable_pods]
        empties = [i for i, c in enumerate(cands) if not c.reschedulable_pods]
        out = [withpods[:2], withpods[1:], list(range(len(cands)))]
        if empties:
            out.append([withpods[0], empties[0]])
        return out

    want = pair.run(batches)
    assert len(want[0]) == 2
    _out, masked, _scratch, _why = probe_batches(pair, want)
    assert masked == len(want)


def test_anti_affinity_candidate_pods_ride_masked():
    env = _env_with_pool()
    sel = {"matchLabels": {"app": "x"}}
    for i in range(4):
        env.store.create(
            make_pod(cpu="250m", name=f"s{i}", labels={"app": "x"}, anti_affinity=[hostname_anti_affinity(sel)]))
    env.settle()
    pair = flipped(env)
    n = pair.run(lambda side: len(side.dc.get_candidates()))
    assert n >= 2
    probe_batches(pair, [[0, 1], [0], list(range(n))])


def test_hostname_spread_routes_to_scratch():
    pair = flipped(_spread_env(host=True))
    _out, masked, scratch_n, why = probe_batches(pair, [[0, 1]], want_mode="scratch")
    assert masked == 0 and scratch_n == 1 and "hostname spread" in why


def test_ffd_solver_routes_to_scratch():
    pair = flipped(fleet_env(4))

    def run(side):
        side.prov.solver = side.m("solver.ffd").FFDSolver()
        sim, cands = simulator(side)
        r = sim.simulate(cands[:2])
        return canonical_results(r), sim.last_mode, sim.why_scratch

    _r, mode, why = pair.run(run)
    assert mode == "scratch" and "tensor path" in why


@pytest.mark.parametrize("break_claim", [False, True])
def test_validate_results(break_claim):
    """`solver/validate.validate_results`, the object-level checker: on a
    solve's `Results` (the port's over the carried snapshot, the
    reference's over its own) the same verdict, none on a sound solve and
    the same violations once a claim loses its instance types."""
    import bench
    from karpenter_tpu.solver.tpu import TPUSolver
    from karpenter_tpu.solver.validate import validate_results as ref_validate
    from karpenter_tpu_torch.solver.gpu import GPUSolver
    from karpenter_tpu_torch.solver.validate import validate_results
    from karpenter_tpu_torch.testing.carry_over import snapshot_from_reference
    from test_torch_solve import clear_globals, next_start, same_state

    ref_snap = bench.build_snapshot(200, 20)
    port_snap = snapshot_from_reference(ref_snap)
    out = []
    start = next_start()
    for solver, snap, check in ((TPUSolver(recover=False), ref_snap, ref_validate),
                                (GPUSolver(device="cpu"), port_snap, validate_results)):
        same_state(start)
        clear_globals()
        results = solver.solve(snap)
        if break_claim:
            results.new_node_claims[0].instance_type_options = []
        out.append(check(snap, results))
    assert out[0] == out[1]
    assert bool(out[1]) == break_claim
