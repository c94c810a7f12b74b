"""`_waterfill` and `_waterfill_multi` of the port against the JAX reference
on seeded random cases (exact integer results)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.models.scheduler_model_grouped import _waterfill as ref_waterfill
from karpenter_tpu.models.scheduler_model_grouped import _waterfill_multi as ref_waterfill_multi
from karpenter_tpu_torch.models.scheduler_model_grouped import _waterfill, _waterfill_multi

# the plain scan is thousands of tiny ops: one intra-op thread per test worker
torch.set_num_threads(1)

INF_I = 2**30
_ref_wf = jax.jit(ref_waterfill)
_ref_wfm = jax.jit(ref_waterfill_multi)


@pytest.mark.parametrize("seed", range(8))
def test_waterfill_matches_reference(seed):
    rng = np.random.default_rng(seed)
    Z = 5
    for _ in range(12):
        v = rng.integers(0, 12, size=Z).astype(np.int32)
        finite = rng.random(Z) < 0.8
        cap = np.where(rng.random(Z) < 0.3, INF_I, rng.integers(0, 9, size=Z)).astype(np.int32)
        cap[rng.random(Z) < 0.1] = -3  # negative headroom clips to 0
        c = np.int32(rng.integers(0, 60))
        want = np.asarray(_ref_wf(v, finite, c, cap))
        got = _waterfill(torch.as_tensor(v), torch.as_tensor(finite), torch.tensor(c), torch.as_tensor(cap))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(8))
def test_waterfill_multi_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    G, D = 6, 5
    for _ in range(10):
        counts = rng.integers(0, 6, size=(G, D)).astype(np.int32)
        member = np.zeros(G, bool)
        member[rng.choice(G, size=int(rng.integers(2, 4)), replace=False)] = True
        skew = rng.integers(1, 4, size=G).astype(np.int32)
        reg = rng.random((G, D)) < 0.85
        min_dom = np.where(rng.random(G) < 0.3, rng.integers(1, 7, size=G), 0).astype(np.int32)
        za = rng.random(D) < 0.9
        avail = rng.random(D) < 0.85
        c = np.int32(rng.integers(0, 40))
        want = np.asarray(_ref_wfm(counts, member, skew, reg, min_dom, za, avail, c))
        got = _waterfill_multi(*(torch.as_tensor(x) for x in (counts, member, skew, reg, min_dom, za, avail)),
                               torch.tensor(c))
        np.testing.assert_array_equal(got.numpy(), want)
