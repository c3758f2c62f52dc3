"""`mx.nd.random` namespace (parity: python/mxnet/ndarray/random.py).

Each function draws from the port's generator for the result's device
(``mx.random.seed`` resets them): scalar parameters give an array of
``shape`` on ``ctx`` (the current context when unset, ``gpu(0)`` by
default) through a ``_random_*`` op; tensor parameters (``uniform``,
``normal``) give ``shape`` draws per element, on their device, through a
``_sample_*`` op.  ``out`` receives the result when given.
"""
from __future__ import annotations

import torch

from .register import invoke


def _run(op, inputs, kwargs, out=None):
    res = invoke(op, inputs, kwargs)
    if out is None:
        return res
    with torch.no_grad():
        out.copy_(res)
    return out


def _sample(name, params, shape, dtype, ctx, out):
    """``_sample_<name>`` when a parameter is a tensor, else
    ``_random_<name>``: ``params`` holds (name, value) pairs."""
    if any(isinstance(v, torch.Tensor) for _, v in params):
        return _run("_sample_" + name, [v for _, v in params],
                    dict(shape=shape, dtype=dtype), out)
    return _run("_random_" + name, [],
                dict(params, shape=shape, dtype=dtype, ctx=ctx), out)


def uniform(low=0, high=1, shape=(), dtype="float32", ctx=None, out=None):
    return _sample("uniform", (("low", low), ("high", high)), shape, dtype,
                   ctx, out)


def normal(loc=0, scale=1, shape=(), dtype="float32", ctx=None, out=None):
    return _sample("normal", (("loc", loc), ("scale", scale)), shape, dtype,
                   ctx, out)


def randn(*shape, loc=0, scale=1, dtype="float32", ctx=None):
    return normal(loc, scale, shape or (1,), dtype=dtype, ctx=ctx)


def gamma(alpha=1, beta=1, shape=(), dtype="float32", ctx=None, out=None):
    return _run("_random_gamma", [], dict(alpha=alpha, beta=beta, shape=shape,
                                          dtype=dtype, ctx=ctx), out)


def exponential(lam=1, shape=(), dtype="float32", ctx=None, out=None):
    return _run("_random_exponential", [],
                dict(lam=lam, shape=shape, dtype=dtype, ctx=ctx), out)


def poisson(lam=1, shape=(), dtype="float32", ctx=None, out=None):
    return _run("_random_poisson", [],
                dict(lam=lam, shape=shape, dtype=dtype, ctx=ctx), out)


def negative_binomial(k=1, p=1, shape=(), dtype="float32", ctx=None,
                      out=None):
    return _run("_random_negative_binomial", [],
                dict(k=k, p=p, shape=shape, dtype=dtype, ctx=ctx), out)


def generalized_negative_binomial(mu=1, alpha=1, shape=(), dtype="float32",
                                  ctx=None, out=None):
    return _run("_random_generalized_negative_binomial", [],
                dict(mu=mu, alpha=alpha, shape=shape, dtype=dtype,
                     ctx=ctx), out)


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None):
    return _run("_random_randint", [], dict(low=low, high=high, shape=shape,
                                            dtype=dtype, ctx=ctx), out)


def multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """Class ids drawn from the probability rows of ``data``; ``get_prob``
    returns no log-probabilities, as in the JAX package."""
    return invoke("_sample_multinomial", [data],
                  dict(shape=shape, get_prob=get_prob, dtype=dtype))


def shuffle(data):
    """``data`` with its rows (axis 0) in a random order."""
    return invoke("_shuffle", [data], {})
