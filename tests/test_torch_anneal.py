"""K7's plain version (`anneal_plain`) against the JAX `anneal_chains`,
on the CPU.

The chains start from the reference's own random streams (x0, flips, u
replayed from `jax.random`). Tolerance: exact. The objective adds in
XLA:CPU's order and rounds `savings - churn_weight * cost` and the
temperature's `|s| * 0.1 + 1e-3` once, as XLA's fused multiply-adds do, so
every score the chain compares is the reference's. The accept test
compares u with exp(.) in float32, where torch's exp and XLA's may differ in
the last bit; a chain whose u sat within that of the threshold would take
another branch from there on. On every fixture no chain diverges: best_x
and best_s equal the reference's for all 64 chains.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.models import consolidation_model as jcm
from karpenter_tpu_torch.kernels import build
from karpenter_tpu_torch.kernels.anneal import (
    anneal,
    anneal_plain,
    anneal_prepass,
    anneal_prepass_plain,
    fma,
    kept_rows_plain,
    pack_compat_plain,
    temperature_fractions,
)
from karpenter_tpu_torch.models.consolidation_model import objective_plain
from karpenter_tpu_torch.solver.consolidation import tensors_from_problem
from test_torch_consolidation import ANNEAL_NAMES, load

torch.set_num_threads(1)

T_FIELDS = ("node_price", "node_cost", "node_slack", "node_used", "node_npods", "pod_compat", "row_alloc", "row_price")


def _args(name):
    problem, ref = load(name)
    t, _aux = tensors_from_problem(problem, "cpu", dense_compat=True)
    return problem, ref, t


@pytest.mark.parametrize("name", ANNEAL_NAMES)
def test_chains_equal_reference(name):
    problem, ref, t = _args(name)
    bx, bs = anneal_plain(t, *(torch.from_numpy(ref[k]) for k in ("ref_x0", "ref_flips", "ref_u")))
    np.testing.assert_array_equal(bx.numpy(), ref["ref_best_x"])
    np.testing.assert_array_equal(bs.numpy().view(np.int32), ref["ref_best_s"].view(np.int32))


@pytest.mark.parametrize("name", ANNEAL_NAMES)
def test_objective_equals_reference_on_random_sets(name):
    problem, ref, t = _args(name)
    rng = np.random.default_rng(7)
    Np = t.node_price.shape[0]
    X = rng.random((16, Np)) < rng.choice([0.05, 0.3, 0.7, 1.0], size=(16, 1))
    X[0] = False
    jt = jcm.ConsolidationTensors(*(jnp.asarray(getattr(t, f).numpy()) for f in T_FIELDS))
    want_s, want_f = jax.jit(jax.vmap(lambda x: jcm._objective(jt, x)))(jnp.asarray(X))
    s, f = objective_plain(t, torch.from_numpy(X))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(want_s).view(np.int32))
    np.testing.assert_array_equal(f.numpy(), np.asarray(want_f))


def test_temperature_is_xlas():
    """max(0.02, 1 - i/S) * (|s| * 0.1 + 1e-3) as the reference forms it."""
    rng = np.random.default_rng(0)
    s = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096)).astype(np.float32)
    i = rng.integers(0, 512, 4096).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s, i: jnp.maximum(0.02, 1.0 - i / 512) * (jnp.abs(s) * 0.1 + 1e-3)))(s, i))
    got = torch.from_numpy(temperature_fractions(512)[i]) * fma(torch.from_numpy(s).abs(), 0.1, 1e-3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_runs_plain_version_only_on_cpu():
    problem, ref, t = _args("small_anneal_4")
    streams = [torch.from_numpy(ref[k][:, :40].copy()) for k in ("ref_x0", "ref_flips", "ref_u")]
    streams[0] = torch.from_numpy(ref["ref_x0"])
    build.reset_launches()
    got = anneal(t, *streams)
    want = anneal_plain(t, *streams)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert build.LAUNCHES["anneal"] == 0
    with pytest.raises(ValueError):
        anneal(t, streams[0].to("meta"), *streams[1:])


def _unpack(words: torch.Tensor, M: int) -> torch.Tensor:
    """[N, nW] int32 words -> [N, M] bool (bit k of word w = column 32 w + k)."""
    bits = (words.long().unsqueeze(-1) >> torch.arange(32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :M].bool()


@pytest.mark.parametrize("name", ANNEAL_NAMES)
def test_pack_compat_plain_matches_dense(name):
    """K7's pre-pass packing (plain version) on each anneal fixture: row j of
    hostbits is pod_compat[j, :], row i of delbits is pod_compat[:, i]."""
    _problem, _ref, t = _args(name)
    hostbits, delbits = pack_compat_plain(t.pod_compat)
    N = t.pod_compat.shape[0]
    assert hostbits.shape == delbits.shape == (N, (N + 31) // 32) and hostbits.dtype == torch.int32
    assert torch.equal(_unpack(hostbits, N), t.pod_compat != 0)
    assert torch.equal(_unpack(delbits, N), (t.pod_compat != 0).t())


@pytest.mark.parametrize("n", [1, 45, 100])
def test_pack_compat_plain_random_ragged(n):
    """A random 0/1 matrix whose side is not a multiple of 32: the last
    word's high bits stay 0."""
    m = torch.from_numpy((np.random.default_rng(n).random((n, n)) < 0.5).astype(np.float32))
    hostbits, delbits = pack_compat_plain(m)
    assert torch.equal(_unpack(hostbits, n), m != 0) and torch.equal(_unpack(delbits, n), (m != 0).t())
    pad = ((n + 31) // 32) * 32 - n
    if pad:
        assert int((hostbits[:, -1].long() >> (32 - pad)).abs().sum()) == 0
        assert int((delbits[:, -1].long() >> (32 - pad)).abs().sum()) == 0


@pytest.mark.parametrize("bad", [0.5, 2.0, float("nan"), -1.0])
def test_pack_compat_rejects_entries_other_than_0_and_1(bad):
    """A non-0/1 entry raises, as the wrapper does on the card (its flag)."""
    _problem, ref, t = _args("small_anneal_4")
    pc = t.pod_compat.clone()
    pc[3, 5] = bad
    with pytest.raises(ValueError, match="only 0 and 1"):
        pack_compat_plain(pc)
    flips = torch.from_numpy(ref["ref_flips"])
    with pytest.raises(ValueError, match="only 0 and 1"):
        anneal_prepass(dataclasses.replace(t, pod_compat=pc), flips)


def test_prepass_rejects_flips_out_of_range():
    _problem, ref, t = _args("small_anneal_4")
    flips = torch.from_numpy(ref["ref_flips"]).clone()
    flips[0, 7] = t.pod_compat.shape[0]
    with pytest.raises(ValueError, match="flips outside"):
        anneal_prepass(t, flips)


@pytest.mark.parametrize("name", ANNEAL_NAMES)
def test_kept_rows_hold_the_cheapest_fitting_row(name):
    """The cheapest row covering a shortfall, over the rows no other row
    dominates, is the reference's minimum over all rows: on each fixture's
    rows, for shortfalls drawn around their allocatable."""
    _problem, _ref, t = _args(name)
    keep = kept_rows_plain(t.row_alloc, t.row_price)
    assert 0 < int(keep.sum()) <= keep.numel()
    rng = np.random.default_rng(3)
    scale = float(t.row_alloc.max())
    sf = torch.from_numpy((rng.random((256, t.row_alloc.shape[1])) * scale * rng.choice([0.01, 0.3, 1.2], (256, 1)))
                          .astype(np.float32))
    big = torch.tensor(3.4e38, dtype=torch.float32)

    def cheapest(alloc, price):
        fits = (alloc.unsqueeze(0) >= sf.unsqueeze(1)).all(-1)
        return torch.where(fits, price, big).amin(1)

    assert torch.equal(cheapest(t.row_alloc[keep], t.row_price[keep]), cheapest(t.row_alloc, t.row_price))


def test_prepass_runs_plain_version_only_on_cpu():
    _problem, ref, t = _args("anneal_256")
    flips = torch.from_numpy(ref["ref_flips"])
    build.reset_launches()
    hostbits, delbits, keep, flag = anneal_prepass(t, flips)
    want = anneal_prepass_plain(t, flips)
    assert all(torch.equal(a, b) for a, b in zip((hostbits, delbits, keep), want)) and int(flag) == 0
    assert build.LAUNCHES["anneal_pack"] == 0 and build.LAUNCHES["anneal"] == 0
