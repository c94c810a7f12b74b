"""The port's consolidation proposers against the JAX package, on the CPU.

Every fixture of `karpenter_tpu_torch/fixtures/consolidation/` (see
`test_torch_consolidation_fixtures.py`):

* `tensors_from_problem` equals the reference's `encode_candidates_lp`
  arrays, array by array (exact);
* fed the stored JAX fractional deletions d, the port's rounding, discrete
  scores (K6's plain version) and ladder give the JAX rows and the JAX
  proposal list exactly, and the global proposer's `info` (rounded rows
  exactly, objective improvement within the scores' tolerance);
* each proposer end to end from the JAX inits (its own K5 / K7 plain run)
  gives the JAX proposal list, where no rounding cut or prefix boundary
  separates two real nodes whose JAX d values are closer than the d
  tolerance of `test_torch_globalpack.py` (every fixture here qualifies; the
  test checks that it does, so a fixture that did not would show).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.solver.consolidation import (
    ROUND_THRESHOLDS,
    ConsolidationProblem,
    global_ladder,
    load_npz,
    lp_ladder,
    propose_problem_anneal,
    propose_problem_global,
    propose_problem_lp,
    reference_inits,
    reference_proposals,
    save_npz,
    tensors_from_problem,
)
from test_torch_consolidation_fixtures import AUX_FIELDS, CONS_DIR, CORPUS, T_FIELDS

torch.set_num_threads(1)

GP_NAMES = sorted(n for n, (_f, kind) in CORPUS.items() if kind in ("lp", "global"))
SMALL_GP = [n for n in GP_NAMES if n.startswith("small_")]
ANNEAL_NAMES = sorted(n for n, (_f, kind) in CORPUS.items() if kind == "anneal")
D_TOL = 2e-6  # |d_port - d_jax| after the full ascent (measured: test_torch_globalpack.py)
SCORE_RTOL = 1e-6  # discrete scores: float32 sums in another order


def load(name):
    return load_npz(CONS_DIR / f"{name}.npz")


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_tensors_equal_encode_candidates_lp(name):
    problem, ref = load(name)
    kind = str(ref["kind"])
    t, aux = tensors_from_problem(problem, "cpu", dense_compat=kind == "anneal")
    for f in T_FIELDS:
        if f == "pod_compat" and kind != "anneal":
            assert tuple(t.pod_compat.shape) == (1, 1)
            continue
        np.testing.assert_array_equal(getattr(t, f).numpy(), ref[f"ref_t_{f}"], err_msg=f)
    for f in AUX_FIELDS:
        got = aux[f] if f == "pend_npods" else aux[f].numpy()
        np.testing.assert_array_equal(np.asarray(got, np.float32), ref[f"ref_aux_{f}"], err_msg=f)
    np.testing.assert_array_equal(aux["compat_qn"].numpy(), ref["ref_aux_compat_nq"].T)
    assert aux["n"] == problem.n and aux["n_classes"] == problem.n_classes


def test_problem_npz_round_trip(tmp_path):
    problem, _ref = load("small_global_6_pending")
    save_npz(tmp_path / "p.npz", problem, ref_x=np.arange(3))
    again, extra = load_npz(tmp_path / "p.npz")
    for key, want in problem.arrays().items():
        np.testing.assert_array_equal(again.arrays()[key], want, err_msg=key)
    assert isinstance(again, ConsolidationProblem) and again.pend_npods == problem.pend_npods
    np.testing.assert_array_equal(extra["ref_x"], np.arange(3))
    with pytest.raises(ValueError):
        save_npz(tmp_path / "q.npz", problem, node_price=np.zeros(1))


@pytest.mark.parametrize("name", GP_NAMES)
def test_ladder_from_jax_d_gives_jax_proposals(name):
    """§(a): rounding, scoring and ladder fed the stored JAX d."""
    problem, ref = load(name)
    t, aux = tensors_from_problem(problem, "cpu")
    if str(ref["kind"]) == "lp":
        out, X, scores, feas = lp_ladder(t, aux, ref["ref_d"], problem.n)
    else:
        out, info, X, scores, feas = global_ladder(t, aux, ref["ref_d"], problem.n)
        assert info["rounded"] == int(ref["ref_info_rounded"])
        want = float(ref["ref_info_objective_improvement"])
        assert info["objective_improvement"] == pytest.approx(want, rel=1e-5, abs=1e-5)
    np.testing.assert_array_equal(X, ref["ref_X"])
    np.testing.assert_array_equal(feas, ref["ref_feas"])
    np.testing.assert_allclose(scores, ref["ref_scores"], rtol=SCORE_RTOL, atol=1e-5)
    assert out == reference_proposals(ref)


def _close_cuts(d_ref, n, tol) -> list:
    """Thresholds and prefix boundaries of the rounding that fall between two
    real nodes whose reference d values differ by at most `tol` (the port's
    d, within `tol` of the reference's, could round differently there; an
    exact tie of two clipped values, 0 or 1, is exact in both)."""
    found = []
    for c, dc in enumerate(np.asarray(d_ref)[:, :n]):
        for tau in ROUND_THRESHOLDS:
            if np.any(np.abs(dc - tau) <= tol):
                found.append((c, "threshold", tau))
        srt = np.sort(dc)[::-1]
        ks = {2, max(2, n // 4), max(2, n // 2)} | {max(2, (n * f) // 8) for f in range(1, 9)}
        for k in sorted(ks):
            gap = srt[k - 1] - srt[k] if 0 < k < n else np.inf
            if gap <= tol and not (gap == 0 and srt[k] in (0.0, 1.0)):
                found.append((c, "prefix", k))
    return found


@pytest.mark.parametrize("name", SMALL_GP + ["lp_5000", "global_5000_hetero", "global_5000_hetero_pending"])
def test_proposer_end_to_end_from_jax_inits(name):
    """§(b): each LP proposer from the JAX inits gives the JAX proposals (a
    fixture where a cut separates reference d values closer than D_TOL
    would have to be named here and in PERF.md; none is)."""
    problem, ref = load(name)
    inits = reference_inits(problem, ref)
    if str(ref["kind"]) == "lp":
        out = propose_problem_lp(problem, "cpu", inits=inits)
    else:
        out, info = propose_problem_global(problem, "cpu", inits=inits)
        assert info["rounded"] == int(ref["ref_info_rounded"])
    assert out == reference_proposals(ref), f"{name}: close cuts {_close_cuts(ref['ref_d'], problem.n, D_TOL)}"


def test_near_tie_fixture_proposals_from_jax_inits():
    """`lp_300_near_tie` (ROADMAP Queue 3 item 2): the JAX d of init 6 has
    nodes 39 and 239 3.6e-7 apart at the top-2 prefix boundary, closer than
    the port's d is to JAX's. The LP proposer from the JAX inits still gives
    the JAX proposals."""
    problem, ref = load("lp_300_near_tie")
    d_ref = ref["ref_d"]
    assert (6, "prefix", 2) in _close_cuts(d_ref, problem.n, 1e-6)
    order = np.argsort(-d_ref[6, :problem.n])
    assert set(order[:2].tolist()) & {39, 239} and 0 < abs(float(d_ref[6, 39]) - float(d_ref[6, 239])) < 1e-6
    out = propose_problem_lp(problem, "cpu", inits=reference_inits(problem, ref))
    assert out == reference_proposals(ref)


@pytest.mark.parametrize("name", ANNEAL_NAMES)
def test_anneal_proposer_from_jax_streams(name):
    problem, ref = load(name)
    out = propose_problem_anneal(problem, "cpu", streams=(ref["ref_x0"], ref["ref_flips"], ref["ref_u"]))
    assert out == reference_proposals(ref)


def test_proposers_draw_their_own_inits_from_a_generator():
    """Without explicit inits each proposer draws from the reference's own
    generator (`utils.prng`: jax.random's Threefry streams for the seed), so
    with the fixture's seed it gives the JAX proposals, and the same seed
    gives the same proposals again."""
    for name in ("small_global_6_pending", "small_lp_6"):
        problem, ref = load(name)
        seed = int(ref["seed"])
        if str(ref["kind"]) == "lp":
            out = propose_problem_lp(problem, "cpu", seed=seed)
        else:
            out, info = propose_problem_global(problem, "cpu", seed=seed)
            assert info["rounded"] == int(ref["ref_info_rounded"]) > 0
        assert out == reference_proposals(ref), name
    problem, ref = load("small_anneal_6")
    assert propose_problem_anneal(problem, "cpu", seed=int(ref["seed"])) == reference_proposals(ref)
    assert propose_problem_lp(problem, "cpu", seed=1) == propose_problem_lp(problem, "cpu", seed=1)


def test_one_candidate_proposes_nothing():
    problem, _ref = load("small_lp_4")
    one = ConsolidationProblem(**{k: (v[:1] if k in ("node_price", "node_cost", "node_slack", "node_used",
                                                     "node_npods", "class_of_node", "label_of_node") else v)
                                  for k, v in vars(problem).items()})
    assert propose_problem_lp(one, "cpu") == []
    assert propose_problem_global(one, "cpu") == ([], dict(objective_improvement=0.0, rounded=0))
    assert propose_problem_anneal(one, "cpu") == []


def test_stage_times_name_every_stage():
    """The proposer's stages are spans on the trace it is given: the
    reference's `lp_repack` and `round`, the port's stages inside them."""
    from karpenter_tpu_torch.obs.trace import SolveTrace

    problem, ref = load("small_lp_6")
    trace = SolveTrace(enabled=True)
    propose_problem_lp(problem, "cpu", inits=reference_inits(problem, ref), trace=trace)
    assert [(s.name, [c.name for c in s.children]) for s in trace.spans] == [
        ("lp_repack", ["tensors", "K5 globalpack"]),
        ("round", ["rounding", "K6 upload", "K6 kernel", "K6 download", "ladder"])]
    assert list(trace.phase_totals) == ["tensors", "K5 globalpack", "lp_repack", "rounding", "K6 upload", "K6 kernel",
                                        "K6 download", "ladder", "round"]
    assert trace.attribution["lp_rounded"] >= 1 and trace.attribution["lp_proposals"] >= 1


def test_global_repack_plan_encoded():
    """GPUSolver's counterpart of TPUSolver.global_repack_plan."""
    from karpenter_tpu_torch.solver.gpu import GPUSolver

    problem, _ref = load("small_global_6_pending")
    out, info = GPUSolver("cpu").global_repack_plan_encoded(problem, seed=0)
    assert (out, info) == propose_problem_global(problem, "cpu", seed=0)


def test_default_device_needs_cuda():
    problem, _ref = load("small_lp_4")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        propose_problem_lp(problem)
