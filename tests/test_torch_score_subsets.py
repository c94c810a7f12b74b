"""K6's plain version (`objective_factored_plain`) against the JAX
`_score_subsets_impl`, on the CPU.

Tolerance: exact. The reference's sums are XLA:CPU's (windows of 32
consecutive float32 terms added in order, then the window sums the same
way; `xla_sum`), and it contracts `savings - churn_weight * cost` into one
fused multiply-add (`fma_score`); the plain version and the kernel do the
same, so scores are bit-identical and feasibility flags equal. Checked on
every rounded row the reference scored in the fixtures, on random
delete-sets with and without pending pods (including pad nodes, which the
global proposer's prefixes can reach), and for the summation order itself,
including the kernel's (`cluster_order_sum`: a cluster's blocks sum their
1024-node tiles and finish the levels above in rank order).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.models import globalpack as jgp
from karpenter_tpu.models.consolidation_model import ConsolidationTensors as JaxTensors
from karpenter_tpu_torch.kernels import build
from karpenter_tpu_torch.kernels.score_subsets import score_subsets
from karpenter_tpu_torch.models.consolidation_model import _ordered_sum, fma_score, xla_sum
from karpenter_tpu_torch.models.globalpack import objective_factored_plain, score_subsets_global
from karpenter_tpu_torch.solver.consolidation import tensors_from_problem
from test_torch_consolidation import GP_NAMES, load

torch.set_num_threads(1)

T_FIELDS = ("node_price", "node_cost", "node_slack", "node_used", "node_npods", "pod_compat", "row_alloc", "row_price")


def _args(name):
    problem, ref = load(name)
    t, aux = tensors_from_problem(problem, "cpu")
    return problem, ref, t, aux


def _reference(t, aux, X):
    jt = JaxTensors(*(jnp.asarray(getattr(t, f).numpy()) for f in T_FIELDS))
    s, f = jgp._score_subsets_impl(jt, jnp.asarray(aux["onehot"].numpy()), jnp.asarray(aux["compat_nq"].numpy()),
                                   jnp.asarray(aux["pend_req"].numpy()), jnp.float32(aux["pend_npods"]),
                                   jnp.asarray(aux["pend_active"].numpy()), jnp.asarray(X))
    return np.asarray(s), np.asarray(f)


def _plain(t, aux, X):
    s, f = objective_factored_plain(t, aux["onehot"], aux["compat_nq"], aux["pend_req"], aux["pend_npods"],
                                    aux["pend_active"], torch.from_numpy(X))
    return s.numpy(), f.numpy()


@pytest.mark.parametrize("name", GP_NAMES)
def test_scores_of_the_reference_rows(name):
    problem, ref, t, aux = _args(name)
    s, f = _plain(t, aux, ref["ref_X"])
    np.testing.assert_array_equal(s.view(np.int32), ref["ref_scores"].view(np.int32))
    np.testing.assert_array_equal(f, ref["ref_feas"])


@pytest.mark.parametrize("name", ["small_lp_7", "small_global_6_pending", "lp_5000", "global_5000_hetero_pending"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_delete_sets(name, seed):
    """32 random rows of mixed density, pad nodes included in some."""
    problem, ref, t, aux = _args(name)
    rng = np.random.default_rng(seed)
    Np = t.node_price.shape[0]
    dens = rng.choice([0.01, 0.1, 0.5, 0.9, 1.0], size=(32, 1))
    X = rng.random((32, Np)) < dens
    X[::3, problem.n:] = False
    X[0] = False
    s, f = _plain(t, aux, X)
    want_s, want_f = _reference(t, aux, X)
    np.testing.assert_array_equal(s.view(np.int32), want_s.view(np.int32))
    np.testing.assert_array_equal(f, want_f)
    assert f.any() and (s > -1e37).any()


def test_batches_pad_to_32_rows_like_the_reference():
    problem, ref, t, aux = _args("small_global_6_pending")
    X = ref["ref_X"][:5]
    s, f = score_subsets_global(t, aux["onehot"], aux["compat_nq"], aux["pend_req"], aux["pend_npods"],
                                aux["pend_active"], X)
    assert s.shape == (5,) and f.shape == (5,)
    np.testing.assert_array_equal(s, ref["ref_scores"][:5])


@pytest.mark.parametrize("n", [16, 32, 64, 256, 2048, 8192, 16384])
def test_xla_sum_is_xla_cpus_order(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((8, n, 3)) * rng.choice([1.0, 1e-3, 1e4], (8, n, 3))).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda a: a.sum(axis=0)))(x))
    got = xla_sum(torch.from_numpy(x), 1).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if n > 32:  # another order would show on these inputs
        assert not np.array_equal(x.astype(np.float64).sum(1).astype(np.float32), want)
    with pytest.raises(ValueError):
        xla_sum(torch.zeros(2, 48), 1)


K6_SOURCE = build.CSRC / "score_subsets.cu"
TILE, CLUSTER = 1024, 8  # the kernel's K6_TILE and K6_CLUSTER


def cluster_shape(n: int) -> tuple[int, int]:
    """How K6 splits an n-node axis: (tile nodes S, cluster blocks C); each
    block owns n / (S C) consecutive tiles."""
    s = min(n, TILE)
    c = CLUSTER
    while (n // s) % c:
        c //= 2
    return s, c


def cluster_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sums over the last axis in K6's order: each block's tiles
    summed as 32-term windows added in order, then the windows' sums in
    order; every block's tile sums gathered in rank order; then XLA:CPU's
    levels above them (`xla_sum`)."""
    n = x.shape[-1]
    s, c = cluster_shape(n)
    tiles = n // s
    windows = s // 32 if s >= 32 else 1
    per_block = []
    for b in range(c):  # block b owns tiles [b * tiles / c, (b + 1) * tiles / c)
        mine = x[..., b * (n // c):(b + 1) * (n // c)]
        w = _ordered_sum(mine.reshape(*x.shape[:-1], tiles // c, windows, s // windows))
        per_block.append(_ordered_sum(w))
    return xla_sum(torch.cat(per_block, dim=-1), -1)


def test_cluster_model_is_the_kernels_split():
    src = K6_SOURCE.read_text()
    assert re.search(r"^#define K6_TILE (\d+)", src, re.M).group(1) == str(TILE)
    assert re.search(r"^#define K6_CLUSTER (\d+)", src, re.M).group(1) == str(CLUSTER)


@pytest.mark.parametrize("n", [32, 256, 1024, 8192, 32768])
def test_cluster_order_is_xla_cpus_order(n):
    """K6's cluster order (a block's tiles of 1024 nodes summed as 32-term
    windows, then every block's tile sums in rank order and XLA's levels
    above) is bit-equal to `xla_sum` and to XLA:CPU's own sum."""
    rng = np.random.default_rng(n + 1)
    x = (rng.standard_normal((6, n)) * rng.choice([1.0, 1e-3, 1e4], (6, n))).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda a: a.sum()))(x))
    got = cluster_order_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(xla_sum(torch.from_numpy(x), 1).numpy().view(np.int32), want.view(np.int32))
    tile, blocks = cluster_shape(n)
    assert (tile, blocks) == (min(n, 1024), min(8, max(1, n // 1024)))


def test_fma_score_is_xlas_fused_multiply_add():
    rng = np.random.default_rng(3)
    a = (rng.random(4096) * 400).astype(np.float32)
    c = (rng.random(4096) * 4e7).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, c: a - 1e-4 * c)(a, c))
    got = fma_score(torch.from_numpy(a), 1e-4, torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(a - np.float32(1e-4) * c, want)  # two roundings differ


def test_wrapper_runs_plain_version_only_on_cpu():
    problem, ref, t, aux = _args("small_lp_6")
    X = torch.from_numpy(ref["ref_X"])
    build.reset_launches()
    s, f = score_subsets(t, aux["onehot"], aux["compat_nq"], aux["pend_req"], aux["pend_npods"], aux["pend_active"], X)
    assert torch.equal(s, torch.from_numpy(ref["ref_scores"])) and build.LAUNCHES["score_subsets"] == 0
    with pytest.raises(ValueError):
        score_subsets(t, aux["onehot"], aux["compat_nq"], aux["pend_req"], aux["pend_npods"], aux["pend_active"],
                      X.to("meta"))
