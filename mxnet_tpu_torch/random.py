"""Framework random state (parity: python/mxnet/random.py).

Initializers draw from the numpy ``host_rng``, exactly as the JAX package's
do, so the same seed gives the same parameters in both packages.  Sampling
ops on tensors draw from an explicit ``torch.Generator`` per device, which
``seed`` resets too.
"""
from __future__ import annotations

import numpy as _np
import torch

_DEFAULT_SEED = 0
_seed = _DEFAULT_SEED
_generators: dict = {}

# host-side RandomState for initializers (never numpy's global one)
host_rng = _np.random.RandomState(_DEFAULT_SEED)


def seed(seed_state: int) -> None:
    """Seed the framework RNG: the host RNG that initializers use and every
    device generator."""
    global _seed
    _seed = int(seed_state)
    host_rng.seed(_seed % (2 ** 32))
    _generators.clear()


def generator(device) -> torch.Generator:
    """The framework's torch.Generator for ``device``, seeded by ``seed``."""
    device = torch.device(device)
    gen = _generators.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed)
        _generators[device] = gen
    return gen


def __getattr__(name):
    """``mx.random.uniform(...)`` and the other samplers: the functions of
    ``mx.nd.random``."""
    from .ndarray import random as _nd_random
    fn = getattr(_nd_random, name, None)
    if fn is None or name.startswith("_"):
        raise AttributeError(name)
    return fn
