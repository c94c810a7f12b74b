"""The port's copy of the reference's random streams (`utils/prng.py`)
against `jax.random`, on the CPU. Exact.

`split`, the raw bits, `uniform` (its fused multiply-add rounded once),
`bernoulli` and `randint` (its 64 bits per value and wrapping uint32
products) over several seeds, shapes and ranges; then the proposers'
compositions: `lp_inits` against `_globalpack_impl`'s draws replayed with
`jax.random` and against every LP and global consolidation fixture's stored
`ref_d0` / `ref_y0`, `anneal_streams` against every anneal fixture's stored
`ref_x0` / `ref_flips` / `ref_u` and against a fresh replay at a random
shape.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.random as jr
from karpenter_tpu_torch.solver.consolidation import bucket, bucket_small, load_npz
from karpenter_tpu_torch.utils import prng
from test_torch_consolidation_fixtures import CONS_DIR, CORPUS, anneal_streams, gp_inits

SEEDS = [0, 1, 4, 7, 12345, 2**31 - 1, -3]
SHAPES = [(), (1,), (5,), (3, 7), (4, 1000)]


def jkey(seed: int):
    return jr.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    k = jkey(seed)
    assert np.array_equal(np.asarray(k), prng.prng_key(seed))
    for n in (2, 3, 8, 64, 1000):
        assert np.array_equal(np.asarray(jr.split(k, n)), prng.split(prng.prng_key(seed), n))
    # a split of a split: every key of a batch at once
    keys = prng.split(prng.prng_key(seed), 5)
    want = np.stack([np.asarray(jr.split(jnp_key, 3)) for jnp_key in jr.split(k, 5)])
    assert np.array_equal(prng.split(keys, 3), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    k, pk = jkey(seed), prng.prng_key(seed)
    assert np.array_equal(np.asarray(jr.bits(k, shape)), prng.random_bits(pk, shape))
    for lo, hi in ((0.0, 1.0), (0.05, 0.95), (0.1, 1.0), (-2.5, 3.0), (1e-3, 1e3)):
        want = np.asarray(jr.uniform(k, shape, minval=lo, maxval=hi))
        got = prng.uniform(pk, shape, lo, hi)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), (lo, hi)
    for p in (0.3, 0.5, 0.01):
        assert np.array_equal(np.asarray(jr.bernoulli(k, p, shape)), prng.bernoulli(pk, p, shape))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed):
    k, pk = jkey(seed), prng.prng_key(seed)
    for shape in ((), (7,), (16, 33)):
        for lo, hi in ((0, 1), (0, 7), (0, 256), (0, 8192), (3, 70000), (0, 100000), (-50, 2**31 - 1), (5, 5)):
            want = np.asarray(jr.randint(k, shape, lo, hi))
            got = prng.randint(pk, shape, lo, hi)
            assert got.dtype == want.dtype and np.array_equal(got, want), (shape, lo, hi)


def test_uniform_rounds_the_fused_multiply_add_once():
    """Over many draws the single rounding differs from a float32 multiply
    then add (so the test would see a plain float32 version), and the port
    equals jax.random everywhere."""
    k, pk = jkey(11), prng.prng_key(11)
    shape = (200_000,)
    want = np.asarray(jr.uniform(k, shape, minval=0.05, maxval=0.95))
    bits = prng.random_bits(pk, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    two_roundings = np.maximum(np.float32(0.05), f * np.float32(np.float32(0.95) - np.float32(0.05)) + np.float32(0.05))
    assert not np.array_equal(two_roundings, want)
    assert np.array_equal(prng.uniform(pk, shape, 0.05, 0.95), want)


@pytest.mark.parametrize("seed,c,n,q", [(0, 8, 16, 4), (3, 8, 512, 4), (9, 2, 64, 8), (21, 8, 1024, 16)])
def test_lp_inits_replay(seed, c, n, q):
    d0, y0 = gp_inits(jkey(seed), c, n, q)
    got_d0, got_y0 = prng.lp_inits(seed, c, n, q)
    assert np.array_equal(got_d0, d0) and np.array_equal(got_y0, y0)


GP_FIXTURES = sorted(name for name, (_f, kind) in CORPUS.items() if kind in ("lp", "global"))
ANNEAL_FIXTURES = sorted(name for name, (_f, kind) in CORPUS.items() if kind == "anneal")


@pytest.mark.parametrize("name", GP_FIXTURES)
def test_lp_inits_equal_every_fixture(name):
    problem, ref = load_npz(CONS_DIR / f"{name}.npz")
    d0, y0 = prng.lp_inits(int(ref["seed"]), ref["ref_d0"].shape[0], bucket(problem.n), bucket_small(problem.n_classes))
    assert np.array_equal(d0, ref["ref_d0"])
    assert np.array_equal(y0[:, :problem.n_classes, :problem.n], ref["ref_y0"])


@pytest.mark.parametrize("name", ANNEAL_FIXTURES)
def test_anneal_streams_equal_every_fixture(name):
    problem, ref = load_npz(CONS_DIR / f"{name}.npz")
    c, s = ref["ref_flips"].shape
    x0, flips, u = prng.anneal_streams(int(ref["seed"]), c, s, bucket(problem.n))
    assert np.array_equal(x0, ref["ref_x0"]) and np.array_equal(flips, ref["ref_flips"]) and np.array_equal(u, ref["ref_u"])


def test_anneal_streams_replay_random_shape():
    rng = np.random.default_rng(5)
    seed, c, s, n = int(rng.integers(0, 2**31)), 6, 40, int(rng.integers(20, 3000))
    want = anneal_streams(jkey(seed), c, s, n)
    got = prng.anneal_streams(seed, c, s, n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_seed_outside_32_bits_refused():
    with pytest.raises(ValueError):
        prng.prng_key(2**31)
    assert jax.random.PRNGKey(0).shape == (2,)
