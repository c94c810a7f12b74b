"""solverlint fixture for the port: wallclock-and-rng-in-solve-path over
torch. Never imported — parsed only.

Seeds draws from torch's global generator (through the module, an alias and
a from-import) and a wallclock read. A seeded `torch.Generator` handed as
`generator=`, the port's key-passing `utils/prng` (the reference's
jax.random, bit for bit) and the pragma'd twin must NOT be flagged.
"""

import time

import torch
import torch as th
from torch import randperm as sneaky_randperm

from karpenter_tpu_torch.utils import prng
from karpenter_tpu_torch.utils.prng import lp_inits


def bad_global_rand(n):
    return torch.rand(n)


def bad_aliased_randint(n):
    return th.randint(0, 10, (n,))


def bad_from_import_randperm(n):
    return sneaky_randperm(n)


def bad_wallclock():
    return time.perf_counter()


def ok_seeded_generator(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=gen)


def ok_prng(seed, n):
    key = prng.prng_key(seed)
    u = prng.uniform(key, (n,))
    d0, y0 = lp_inits(seed, 4, n, 2)
    return u, d0, y0


def ok_pragma(n):
    return torch.randn(n)  # solverlint: ok(wallclock-and-rng-in-solve-path): fixture — proves the pragma form suppresses
