"""The reference's random streams, on the host in numpy.

The reference draws its consolidation proposers' random starts from
`jax.random` with its default Threefry-2x32 generator in the partitionable
layout (`jax_threefry_partitionable`, on by default since JAX 0.5). This
module reproduces those draws bit for bit, so the port proposes from the
same starts as the reference for the same seed:

* `prng_key(seed)` is `PRNGKey(seed)`: the pair (0, seed) of uint32.
* Threefry-2x32 with 20 rounds hashes a counter pair under a key pair.
* `split(key, n)` hashes the counters (0, i) for i < n; key i is the pair of
  the hash's two outputs.
* `random_bits(key, shape)` hashes the counters (0, i) over the flattened
  shape and takes the xor of the two outputs.
* `uniform(key, shape, lo, hi)` puts the top 23 bits into the mantissa of a
  float in [1, 2), subtracts 1 and maps f to max(lo, f * (hi - lo) + lo).
  XLA:CPU contracts that multiply-add into one fused operation, so it is
  rounded once to float32 here.
* `bernoulli(key, p, shape)` is `uniform(key, shape) < p`.
* `randint(key, shape, lo, hi)` draws 64 bits per value from the two keys of
  `split(key)` and reduces them modulo the span in uint32 arithmetic, as
  JAX does (wrapping products included).

`lp_inits` and `anneal_streams` compose these into the reference's own
splits: those of `models/globalpack._globalpack_impl` and of
`models/consolidation_model.anneal_chains`.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counters (x1, x2) under the key
    (k1, k2); every argument broadcasts, all uint32."""
    k1 = np.asarray(k1, dtype=_U32)
    k2 = np.asarray(k2, dtype=_U32)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        a = np.asarray(x1, dtype=_U32) + ks[0]
        b = np.asarray(x2, dtype=_U32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: [0, seed] as uint32."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed & 0xFFFFFFFF], dtype=_U32)


def _hash_counters(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The two hash outputs of the counters (0, i), i < n, under each key
    of `key` [..., 2]: arrays [..., n]."""
    key = np.asarray(key, dtype=_U32)
    lo = np.arange(n, dtype=_U32)
    return threefry2x32(key[..., 0:1], key[..., 1:2], np.zeros_like(lo), lo)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: [..., n, 2] uint32 for key [..., 2]."""
    a, b = _hash_counters(key, n)
    return np.stack([a, b], axis=-1)


def random_bits(key: np.ndarray, shape=()) -> np.ndarray:
    """32 random bits per element of `shape` (uint32), for key [..., 2]:
    [..., *shape]."""
    shape = tuple(shape)
    key = np.asarray(key, dtype=_U32)
    n = int(np.prod(shape)) if shape else 1
    a, b = _hash_counters(key, n)
    return (a ^ b).reshape(key.shape[:-1] + shape)


def _fma_f32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """a * b + c rounded once to float32 (a: float32 array). The product is
    exact in float64; the float64 sum s = p + c carries its rounding error
    e (TwoSum), and a float32 rounding of s can differ from the single
    rounding of p + c only when s lies exactly halfway between two float32
    values, where the sign of e decides."""
    p = a.astype(np.float64) * np.float64(b)
    c64 = np.float64(c)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    # the float32 values just below and just above s
    below = np.where(r64 < s, r, np.nextafter(r, np.float32(-np.inf)))
    above = np.where(r64 > s, r, np.nextafter(r, np.float32(np.inf)))
    mid = (s != r64) & (s - below.astype(np.float64) == above.astype(np.float64) - s)
    fix = mid & (e != 0)
    if fix.any():
        r = np.where(fix, np.where(e > 0, above, below), r)
    return r


def uniform(key: np.ndarray, shape=(), lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, lo, hi)` for key [..., 2]."""
    bits = random_bits(key, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return np.maximum(lo32, _fma_f32(f, np.float32(hi32 - lo32), lo32))


def bernoulli(key: np.ndarray, p: float, shape=()) -> np.ndarray:
    """`jax.random.bernoulli(key, p, shape)` for key [..., 2]."""
    return uniform(key, shape) < np.float32(p)


def randint(key: np.ndarray, shape, lo: int, hi: int) -> np.ndarray:
    """`jax.random.randint(key, shape, lo, hi)` (int32) for key [..., 2]."""
    ks = split(key, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    span = _U32((hi - lo) & 0xFFFFFFFF) if hi > lo else _U32(1)
    with np.errstate(over="ignore"):
        mult = _U32(1 << 16) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
    return (np.int64(lo) + off.astype(np.int64)).astype(np.int32)


def lp_inits(seed: int, n_inits: int, n: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """The relaxed repack's random starts (`_globalpack_impl`): per key of
    `split(PRNGKey(seed), n_inits)`, (k_d, k_y) = split(key), d0 =
    uniform(k_d, (n,), 0.05, 0.95), y0 = uniform(k_y, (q, n), 0.1, 1.0).
    Returns (d0 [C, n], y0 [C, q, n]) float32."""
    keys = split(prng_key(seed), n_inits)
    kk = split(keys, 2)  # [C, 2, 2]
    d0 = uniform(kk[:, 0], (n,), 0.05, 0.95)
    y0 = uniform(kk[:, 1], (q, n), 0.1, 1.0)
    return d0, y0


def anneal_streams(seed: int, n_chains: int, n_steps: int, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The annealed search's streams (`anneal_chains`) for the keys of
    `split(PRNGKey(seed), n_chains)`: `chain_streams` of them."""
    return chain_streams(split(prng_key(seed), n_chains), n_steps, n)


def chain_streams(keys: np.ndarray, n_steps: int, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The streams `anneal_chains` draws from each key of `keys` [C, 2]:
    (k_init, k_loop) = split(key), x0 = bernoulli(k_init, 0.3, (n,)); then
    per step (key, k1, k2) = split(key, 3), the flip randint(k1, (), 0, n)
    and the acceptance draw uniform(k2). Returns (x0 [C, n] bool, flips
    [C, S] int32, u [C, S] float32)."""
    n_chains = keys.shape[0]
    kk = split(keys, 2)
    x0 = bernoulli(kk[:, 0], 0.3, (n,))
    key = kk[:, 1]
    flips = np.empty((n_chains, n_steps), dtype=np.int32)
    u = np.empty((n_chains, n_steps), dtype=np.float32)
    for s in range(n_steps):
        k3 = split(key, 3)
        key = k3[:, 0]
        flips[:, s] = randint(k3[:, 1], (), 0, n)
        u[:, s] = uniform(k3[:, 2], ())
    return x0, flips, u
