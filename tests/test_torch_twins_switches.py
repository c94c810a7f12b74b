"""The reference's suites that toggle its switches, as twins on the port
(`torch_twins`): the unbatched FFD (`test_ffd_batch`), the legacy encode
(`test_encode_columnar`), the decode without its slot-reuse memo
(`test_decode_delta`), the consolidation round without its shared scheduler
seed (`test_tailcut_consolidation`), and multi-node consolidation's
binary-search and annealed arms (`test_consolidation_lp`,
`test_consolidation_tpu`). Tolerance: exact.

Two cases cannot run as they are, and a test of the same claim stands in
for each here:

- `TestAnnealModel.test_objective_prefers_feasible_savings` builds its
  three-node model with `jax.numpy` and calls the JAX-only `_objective`.
  `test_objective_and_chains_on_the_three_node_model` builds the same model
  in each package: the port's `objective_plain` gives the reference's
  `_objective` scores and verdicts bit for bit (none deleted scores 0, two
  deleted are feasible with positive savings), and the port's `anneal`
  (K7's plain version on the CPU) gives the reference's chains from
  `PRNGKey(0)`, whose best reaches that score.
- `TestAnnealQuality.test_anneal_savings_at_least_95pct_of_binary_search`
  runs `bench.bench_consolidation(24)`, which builds its fleet with the
  reference. `test_anneal_quality_on_the_bench_fleet` builds that 24-node
  fleet in each package and runs the bench's quality half: the annealed
  proposals, their exact validation and the binary search over the
  cost-sorted 100-candidate prefix. The port's proposals, acceptances and
  savings equal the reference's, and the anneal recovers at least 95% of the
  binary search's savings.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from torch_twins import (
    assert_every_case_covered,
    assert_twin_case,
    params_of,
    reference_cases,
    same_start,
    seeded_uids,
)

MODULES = ("test_ffd_batch", "test_encode_columnar", "test_decode_delta", "test_tailcut_consolidation",
           "test_consolidation_lp", "test_consolidation_tpu")
NOT_AS_IS = ("TestAnnealModel.test_objective_prefers_feasible_savings",
             "TestAnnealQuality.test_anneal_savings_at_least_95pct_of_binary_search")
CASES = [(m, c) for m in MODULES for c in reference_cases(m) if c not in NOT_AS_IS]

torch.set_num_threads(1)


@pytest.mark.parametrize("module,case", params_of(CASES))
def test_reference_case_matches(module, case):
    assert_twin_case(module, case)


def test_every_case_is_covered():
    assert_every_case_covered(MODULES)
    assert set(NOT_AS_IS) <= set(reference_cases("test_consolidation_tpu"))


def test_objective_and_chains_on_the_three_node_model():
    import jax
    import jax.numpy as jnp

    from karpenter_tpu.models import consolidation_model as jcm
    from karpenter_tpu_torch.models import consolidation_model as cm

    compat = np.ones((3, 3), np.float32)
    np.fill_diagonal(compat, 0)
    fields = dict(node_price=[1.0, 1.0, 1.0], node_cost=[0.1, 0.1, 0.1], node_slack=[[4.0], [4.0], [4.0]],
                  node_used=[[1.0], [1.0], [1.0]], node_npods=[1.0, 1.0, 1.0], pod_compat=compat,
                  row_alloc=[[8.0]], row_price=[0.5])
    jt = jcm.ConsolidationTensors(**{k: jnp.array(v, jnp.float32) for k, v in fields.items()})
    t = cm.ConsolidationTensors(**{k: torch.tensor(np.asarray(v, np.float32)) for k, v in fields.items()})
    X = [[False, False, False], [True, True, False]]
    want = [jcm._objective(jt, jnp.array(x)) for x in X]
    scores, feasible = cm.objective_plain(t, torch.tensor(X))
    np.testing.assert_array_equal(scores.numpy().view(np.int32),
                                  np.array([float(s) for s, _f in want], np.float32).view(np.int32))
    assert feasible.tolist() == [bool(f) for _s, f in want]
    assert float(scores[0]) == 0.0 and bool(feasible[1]) and float(scores[1]) > 0

    ref_x, ref_s = jcm.anneal(jt, jax.random.PRNGKey(0), n_chains=8, n_steps=128)
    best_x, best_s = cm.anneal(t, 0, n_chains=8, n_steps=128)
    np.testing.assert_array_equal(best_x.numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(best_s.numpy().view(np.int32), np.asarray(ref_s).view(np.int32))
    assert float(best_s.max()) >= float(scores[1])


def _bench_quality(pkg: str, n_nodes: int = 24) -> dict:
    """`bench.bench_consolidation(n_nodes)`'s fleet, built in package `pkg`
    (the reference's default "ffd" options; the port's solvers on the CPU),
    and its quality half: the annealed proposals, each exact-validated, and
    the binary search over the cost-sorted 100-candidate prefix."""
    wk = importlib.import_module(f"{pkg}.apis.labels")
    Budget = importlib.import_module(f"{pkg}.apis.nodepool").Budget
    operator = importlib.import_module(f"{pkg}.operator")
    options = importlib.import_module(f"{pkg}.operator.options")
    methods = importlib.import_module(f"{pkg}.controllers.disruption.methods")
    consolidation = importlib.import_module(f"{pkg}.solver.consolidation")
    port = pkg == "karpenter_tpu_torch"
    if port:
        names = importlib.import_module(f"{pkg}.testing.scenarios")
    else:
        import helpers as names

    od_only = [{"key": wk.ARCH_LABEL_KEY, "operator": "In", "values": ["amd64"]},
               {"key": wk.OS_LABEL_KEY, "operator": "In", "values": ["linux"]},
               {"key": wk.CAPACITY_TYPE_LABEL_KEY, "operator": "In", "values": [wk.CAPACITY_TYPE_ON_DEMAND]}]
    same_start(pkg)
    with seeded_uids():
        opts = options.Options(solver_backend="ffd")
        env = operator.Environment(opts, device="cpu") if port else operator.Environment(opts)
        np_ = names.make_nodepool(requirements=od_only)
        np_.spec.disruption.consolidate_after = "30s"
        np_.spec.disruption.budgets = [Budget(nodes="100%")]
        env.store.create(np_)
        sel = {"matchLabels": {"app": "x"}}
        pods = [names.make_pod(cpu="500m", name=f"s{i}", labels={"app": "x"},
                               anti_affinity=[names.hostname_anti_affinity(sel)]) for i in range(n_nodes)]
        for p in pods:
            env.store.create(p)
        env.settle()
        assert env.store.count("Node") == n_nodes
        for p in pods:
            env.store.delete("Pod", p.metadata.name)
        for i in range(n_nodes):
            env.store.create(names.make_pod(cpu="500m", name=f"f{i}"))
        env.settle(rounds=4)
        env.clock.step(40)
        env.nodeclaim_disruption.reconcile()
        cands = env.disruption.get_candidates()
        its = env.cloud_provider.get_instance_types()
        proposals = consolidation.propose_subsets(cands, its, **({"device": "cpu"} if port else {}))
        ctx = env.disruption.ctx
        ctx.round_candidates = cands
        ctx.node_pool_totals = None
        m = methods.MultiNodeConsolidation(ctx)
        accepted, best_anneal = [], 0.0
        for subset in proposals:
            cmd = m.compute_consolidation([cands[i] for i in subset])
            accepted.append(sorted(cmd.candidate_names()))
            if cmd.candidates:
                best_anneal = max(best_anneal, methods._command_savings_per_hour(cmd))
        ordered = sorted(cands, key=lambda c: c.disruption_cost)[:100]
        baseline = m._first_n_consolidation_option(ordered)
    return dict(n_candidates=len(cands), proposals=proposals, accepted=accepted, best_anneal=best_anneal,
                baseline=sorted(baseline.candidate_names()),
                baseline_savings=methods._command_savings_per_hour(baseline))


def test_anneal_quality_on_the_bench_fleet():
    want = _bench_quality("karpenter_tpu")
    got = _bench_quality("karpenter_tpu_torch")
    assert got == want
    assert got["n_candidates"] >= 24 * 0.9 and got["proposals"]
    assert got["baseline_savings"] > 0 and any(got["accepted"])
    assert got["best_anneal"] / got["baseline_savings"] >= 0.95, got
