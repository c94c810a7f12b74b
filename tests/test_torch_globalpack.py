"""K5's plain version (`globalpack_plain`) and the hand-written gradient
against the JAX `_globalpack_impl` and `jax.grad`, on the CPU.

* The gradient of the negated `_gp_objective` with respect to (d, y, yr):
  on every LP / global fixture at its JAX inits (unprojected, where the
  unplaced-mass hinge is off, and projected then halved, where it is on),
  and on crafted inputs that hit each tie JAX resolves by rule:
  `1 - route_total == 0` (d max(x, 0)/dx = 0.5), replacement-row maxima
  tied across resources (split equally), `routed - keep * slack == 0`.
  Tolerance: rtol 1e-5, with an absolute floor of 1e-6 of the array's
  largest entry (terms of opposite sign cancel in float32 in another
  order).
* The bias corrections 1 - b**it against XLA's, exact.
* The ascent from the stored JAX inits after 1, 5 and 300 steps. The
  reference's sums are float32 in XLA:CPU's order; the port's are float64
  rounded once. After every projection a class's route total is 1 within
  an ulp, so whether its unplaced hinge is on (1 - route_total > 0) is
  decided by rounding, and Adam's first steps turn that into +-lr moves of
  y: y and the objective drift apart early, d hardly moves. Tolerances
  (largest errors measured on the fixtures, with margin): d within D_TOL
  at every step count; the objective within 5e-2 relative after 1 step,
  1e-4 after 5, and after 300 steps within 1e-2 of the fixture's total
  node price (the objective is then a small difference of savings and
  penalties).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.models import globalpack as jgp
from karpenter_tpu.models.consolidation_model import ConsolidationTensors as JaxTensors
from karpenter_tpu_torch.kernels import build
from karpenter_tpu_torch.kernels.globalpack import globalpack, globalpack_plain
from karpenter_tpu_torch.models.consolidation_model import ConsolidationTensors
from karpenter_tpu_torch.models.globalpack import (
    adam_corrections,
    gp_grad_plain,
    gp_normalisers,
    gp_objective_plain,
    gp_project,
)
from karpenter_tpu_torch.solver.consolidation import reference_inits, tensors_from_problem
from test_torch_consolidation import GP_NAMES, SMALL_GP, load

torch.set_num_threads(1)

D_TOL = 2e-6
T_FIELDS = ("node_price", "node_cost", "node_slack", "node_used", "node_npods", "pod_compat", "row_alloc", "row_price")


def _jax_grad(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr):
    """jax.grad of the reference's negated objective, vmapped over inits."""
    jt = JaxTensors(*(jnp.asarray(getattr(t, f).numpy()) for f in T_FIELDS))
    ps, ia, nr = (jnp.asarray(x.numpy()) for x in gp_normalisers(t, pend_mass))
    J = [jnp.asarray(x.numpy()) for x in (onehot, compat_qn, pend_mass, pend_weight)]

    def neg(d, y, yr):
        return -jgp._gp_objective(jt, *J, d, y, yr, ia, nr, ps)

    g = jax.vmap(jax.grad(neg, argnums=(0, 1, 2)))(jnp.asarray(d.numpy()), jnp.asarray(y.numpy()),
                                                   jnp.asarray(yr.numpy()))
    obj = jax.vmap(neg)(jnp.asarray(d.numpy()), jnp.asarray(y.numpy()), jnp.asarray(yr.numpy()))
    return [np.asarray(x) for x in g], -np.asarray(obj)


def _assert_grad(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr):
    ps, ia, nr = gp_normalisers(t, pend_mass)
    got = gp_grad_plain(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr, ia, nr, ps)
    want, obj = _jax_grad(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr)
    for name, a, b in zip(("d", "y", "yr"), got, want):
        floor = 1e-6 * float(np.abs(b).max())
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=floor, err_msg=name)
    mine = gp_objective_plain(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr, ia, nr, ps)
    np.testing.assert_allclose(mine.numpy(), obj, rtol=1e-5)
    return got


@pytest.mark.parametrize("name", GP_NAMES)
def test_hand_gradient_matches_jax_grad_on_fixtures(name):
    problem, ref = load(name)
    t, aux = tensors_from_problem(problem, "cpu")
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"])
    d0, y0 = (torch.from_numpy(a) for a in reference_inits(problem, ref))
    yr0 = torch.full((d0.shape[0], aux["onehot"].shape[1], t.row_price.shape[0]), 0.5)
    # hinge off: route totals far above 1
    _assert_grad(*args, d0, y0 * aux["compat_qn"], yr0)
    # hinge on: projected rows, halved (route totals near 0.5)
    y, yr = gp_project(y0, yr0, aux["compat_qn"])
    _assert_grad(*args, d0, y * 0.5, yr * 0.5)


def _crafted():
    """4 nodes (3 real, 1 pad), 2 resources, 2 classes (the second a pad
    class), 3 replacement rows of which row 1 has equal allocatable in both
    resources (its max over resources ties) and row 2 is a pad row."""
    f = torch.float32
    t = ConsolidationTensors(
        node_price=torch.tensor([1.0, 0.5, 2.0, 0.0], dtype=f),
        node_cost=torch.tensor([0.1, 0.2, 0.3, 1e6], dtype=f),
        node_slack=torch.tensor([[2.0, 2.0], [1.0, 3.0], [4.0, 1.0], [0.0, 0.0]], dtype=f),
        node_used=torch.tensor([[1.0, 1.0], [0.5, 0.5], [2.0, 2.0], [0.0, 0.0]], dtype=f),
        node_npods=torch.tensor([1.0, 1.0, 2.0, 0.0], dtype=f),
        pod_compat=torch.zeros((1, 1), dtype=f),
        row_alloc=torch.tensor([[4.0, 8.0], [4.0, 4.0], [0.0, 0.0]], dtype=f),
        row_price=torch.tensor([1.5, 1.0, 3.4e38], dtype=f),
    )
    onehot = torch.tensor([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 0.0]], dtype=f)
    compat_qn = torch.tensor([[1.0, 1.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0]], dtype=f)
    pend_mass = torch.zeros((2, 2), dtype=f)
    pend_weight = torch.ones(2, dtype=f)
    return t, onehot, compat_qn, pend_mass, pend_weight


def test_hand_gradient_ties_follow_jax():
    t, onehot, compat_qn, pend_mass, pend_weight = _crafted()
    f = torch.float32
    # route totals exactly 1 in any order (powers of two): class 0 has mass,
    # class 1 (pad) has none; node 1 fully deleted with nothing routed to it
    # (routed - keep * slack == 0 there)
    d = torch.tensor([[0.5, 1.0, 0.25, 0.0]], dtype=f)
    y = torch.tensor([[[0.0, 0.0, 0.25, 0.0], [0.0, 0.0, 0.0, 0.0]]], dtype=f)
    yr = torch.tensor([[[0.25, 0.5, 0.0], [0.5, 0.25, 0.25]]], dtype=f)
    gd, gy, gyr = _assert_grad(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr)
    ps, ia, nr = gp_normalisers(t, pend_mass)
    from karpenter_tpu_torch.models.globalpack import _forward

    fw = _forward(t, onehot, compat_qn, pend_mass, pend_weight, d, y, yr, ia, nr, ps)
    assert fw["u"][0, 0].item() == 0.0 and fw["class_mass"][0, 0].item() > 0  # the hinge's tie, on a real class
    w = fw["w"][0, 1]
    assert w[0].item() == w[1].item() > 0  # row 1's maximum ties across resources
    assert fw["a"][0, 1].eq(0).all()  # node 1: routed - keep * slack == 0
    # the tie rules change the gradient: at u == 0 the hinge counts half
    hinge = 10.0 * fw["class_mass"][0, 0].item() * 0.5
    assert fw["a"][0, 0].lt(0).all()  # node 0 is under capacity: only the hinge reaches its route
    assert gy[0, 0, 0].item() == pytest.approx(-hinge, rel=1e-6)


def test_adam_corrections_equal_xla():
    its = jnp.arange(1, 2001, dtype=jnp.int32)
    got = adam_corrections(2000)
    for col, b in enumerate((0.9, 0.999)):
        want = np.asarray(jax.jit(lambda it, b=b: 1 - b**it)(its))
        np.testing.assert_array_equal(got[:, col], want)


@pytest.mark.parametrize("name", GP_NAMES)
def test_ascent_matches_reference(name):
    """1, 5 and the full 300 steps from the stored JAX inits against the
    stored JAX outputs."""
    problem, ref = load(name)
    t, aux = tensors_from_problem(problem, "cpu")
    d0, y0 = (torch.from_numpy(a) for a in reference_inits(problem, ref))
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0)
    scale = float(problem.node_price.sum())
    for n_iters, d_key, s_key, s_tol in ((1, "ref_d_it1", "ref_score_it1", 5e-2), (5, "ref_d_it5", "ref_score_it5", 1e-4),
                                         (int(ref["ref_n_iters"]), "ref_d", "ref_lp_score", None)):
        d, s = globalpack_plain(*args, n_iters)
        np.testing.assert_allclose(d.numpy(), ref[d_key], rtol=0, atol=D_TOL, err_msg=f"d after {n_iters}")
        if s_tol is None:
            np.testing.assert_allclose(s.numpy(), ref[s_key], rtol=0, atol=1e-2 * scale, err_msg="objective")
        else:
            np.testing.assert_allclose(s.numpy(), ref[s_key], rtol=s_tol, err_msg=f"objective after {n_iters}")


def test_wrapper_runs_plain_version_only_on_cpu():
    name = SMALL_GP[0]
    problem, ref = load(name)
    t, aux = tensors_from_problem(problem, "cpu")
    d0, y0 = (torch.from_numpy(a) for a in reference_inits(problem, ref))
    args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"])
    build.reset_launches()
    d, s = globalpack(*args, d0, y0, 3)
    d_p, s_p = globalpack_plain(*args, d0, y0, 3)
    assert torch.equal(d, d_p) and torch.equal(s, s_p)
    assert build.LAUNCHES["globalpack"] == 0
    with pytest.raises(ValueError):
        globalpack(*args, d0.to("meta"), y0, 3)


def report() -> None:
    """Print, per fixture, the largest |d - d_jax| and objective error of
    the plain ascent after 1, 5 and 300 steps (the numbers the tolerances
    above are set from):

        JAX_PLATFORMS=cpu python tests/test_torch_globalpack.py --report
    """
    for name in GP_NAMES:
        problem, ref = load(name)
        t, aux = tensors_from_problem(problem, "cpu")
        d0, y0 = (torch.from_numpy(a) for a in reference_inits(problem, ref))
        args = (t, aux["onehot"], aux["compat_qn"], aux["pend_mass"], aux["pend_weight"], d0, y0)
        parts = []
        for n_iters, d_key, s_key in ((1, "ref_d_it1", "ref_score_it1"), (5, "ref_d_it5", "ref_score_it5"),
                                      (int(ref["ref_n_iters"]), "ref_d", "ref_lp_score")):
            d, s = globalpack_plain(*args, n_iters)
            d_err = float(np.abs(d.numpy() - ref[d_key]).max())
            rel = float((np.abs(s.numpy() - ref[s_key]) / np.abs(ref[s_key])).max())
            share = float(np.abs(s.numpy() - ref[s_key]).max() / problem.node_price.sum())
            parts.append(f"{n_iters}: d {d_err:.3g}, objective rel {rel:.3g} (abs / total price {share:.3g})")
        print(name, "; ".join(parts))


if __name__ == "__main__":
    import sys

    if "--report" in sys.argv:
        report()
