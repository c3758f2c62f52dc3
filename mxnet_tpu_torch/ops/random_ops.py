"""Random sampling operators (parity: ``mxnet_tpu/ops/random_ops.py``).

``_random_*`` draw an array of ``shape`` from a distribution with scalar
parameters; ``_sample_*`` draw ``shape`` samples for each element of their
parameter tensors (the output is ``param.shape + shape``);
``_sample_multinomial`` draws class ids from rows of probabilities and
``_shuffle`` permutes axis 0.  Every draw comes from the port's generator
for the output's device (``random.generator``), as Dropout's masks do, and
``random.seed`` resets it: the CUDA generator for a CUDA output, never the
CPU's.  The JAX package splits a jax PRNG key per op instead, so the draws
agree with it in distribution, shape and dtype, not bit for bit.

The zero-input ops take their device from ``ctx`` (the current context
when unset; a Symbol graph fills it with the device it runs on).  On
``torch.device("meta")`` (shape inference) nothing is drawn: the result is
an empty tensor of the right shape and dtype.

The negative binomial is a gamma-Poisson mixture: NB(k, p) is
Poisson(Gamma(k, (1-p)/p)), GNB(mu, alpha) Poisson(Gamma(1/alpha,
mu*alpha)), as in the JAX package.
"""
from __future__ import annotations

import torch

from ..base import Arg, torch_dtype
from .. import random as _random
from .init_ops import device_of
from .registry import register

_SHAPE_ARGS = [Arg("shape", "shape", ()), Arg("dtype", str, "float32"),
               Arg("ctx", str, None)]
_SAMPLE_ARGS = [Arg("shape", "shape", ()), Arg("dtype", str, "float32")]


def _draw(shape, dtype, device, fn):
    """``fn(generator)`` drawn on ``device`` and cast to ``dtype``; an
    empty meta tensor on the meta device."""
    dtype = torch_dtype(dtype)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return fn(_random.generator(device)).to(dtype)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws, one per element of the float tensor alpha."""
    return torch._standard_gamma(alpha, generator=gen)


def _exp(shape, device, gen):
    return torch.empty(shape, device=device).exponential_(1.0, generator=gen)


def _random_op(name, extra, aliases):
    """Register ``_random_<name>``: ``draw(p, shape, device, gen)`` gives
    the float32 samples."""
    def deco(draw):
        @register("_random_" + name, input_names=(), differentiable=False,
                  args=_SHAPE_ARGS + extra, aliases=aliases)
        def op(p):
            device, shape = device_of(p["ctx"]), p["shape"]
            return _draw(shape, p["dtype"], device,
                         lambda gen: draw(p, shape, device, gen))
        op.__doc__ = draw.__doc__
        return draw
    return deco


@_random_op("uniform", [Arg("low", float, 0.0), Arg("high", float, 1.0)],
            ("uniform", "random_uniform"))
def _uniform(p, shape, device, gen):
    """Uniform on [low, high)."""
    u = torch.rand(shape, generator=gen, device=device)
    return p["low"] + u * (p["high"] - p["low"])


@_random_op("normal", [Arg("loc", float, 0.0), Arg("scale", float, 1.0)],
            ("normal", "random_normal"))
def _normal(p, shape, device, gen):
    """Normal with mean ``loc`` and standard deviation ``scale``."""
    return p["loc"] + p["scale"] * torch.randn(shape, generator=gen,
                                               device=device)


@_random_op("gamma", [Arg("alpha", float, 1.0), Arg("beta", float, 1.0)],
            ("random_gamma",))
def _gamma_op(p, shape, device, gen):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    return p["beta"] * _gamma(torch.full(shape, p["alpha"], device=device),
                              gen)


@_random_op("exponential", [Arg("lam", float, 1.0)], ("random_exponential",))
def _exponential(p, shape, device, gen):
    """Exponential with rate ``lam``."""
    return _exp(shape, device, gen) / p["lam"]


@_random_op("poisson", [Arg("lam", float, 1.0)], ("random_poisson",))
def _poisson(p, shape, device, gen):
    """Poisson with rate ``lam``."""
    return torch.poisson(torch.full(shape, p["lam"], device=device),
                         generator=gen)


@_random_op("negative_binomial", [Arg("k", int, 1), Arg("p", float, 1.0)],
            ("random_negative_binomial",))
def _negative_binomial(p, shape, device, gen):
    """Failures before the k-th success of trials that succeed with
    probability p."""
    lam = _gamma(torch.full(shape, float(p["k"]), device=device), gen)
    return torch.poisson(lam * (1 - p["p"]) / p["p"], generator=gen)


@_random_op("generalized_negative_binomial",
            [Arg("mu", float, 1.0), Arg("alpha", float, 1.0)],
            ("random_generalized_negative_binomial",))
def _gen_negative_binomial(p, shape, device, gen):
    """Negative binomial with mean ``mu`` and dispersion ``alpha``."""
    a = 1.0 / max(p["alpha"], 1e-12)
    lam = _gamma(torch.full(shape, a, device=device), gen) * p["mu"] / a
    return torch.poisson(lam, generator=gen)


@register("_random_randint", input_names=(), differentiable=False,
          args=[Arg("low", int, 0), Arg("high", int, required=True),
                Arg("shape", "shape", ()), Arg("dtype", str, "int32"),
                Arg("ctx", str, None)],
          aliases=("random_randint",))
def _randint(p):
    """Integers uniform on [low, high), int32 by default."""
    device = device_of(p["ctx"])
    return _draw(p["shape"], p["dtype"], device, lambda gen: torch.randint(
        p["low"], p["high"], p["shape"], generator=gen, device=device))


@register("_sample_multinomial", input_names=("data",), differentiable=False,
          args=[Arg("shape", "shape", ()), Arg("get_prob", bool, False),
                Arg("dtype", str, "int32")],
          aliases=("sample_multinomial",))
def _multinomial(p, data):
    """Class ids drawn from each row of probabilities ``data`` (1-D: one
    distribution; 2-D: one per row), ``shape`` draws per distribution:
    ``shape`` (1-D data) or ``(rows,) + shape``.  ``get_prob`` is accepted
    and returns no log-probabilities, as in the JAX package."""
    shape = p["shape"]
    n = 1
    for d in shape or (1,):
        n *= d
    out_shape = tuple(shape) if data.dim() == 1 else (data.shape[0],) + tuple(
        shape)
    return _draw(out_shape, p["dtype"], data.device, lambda gen: torch.multinomial(
        torch.clamp(data.float(), min=1e-30), n, replacement=True,
        generator=gen).reshape(out_shape))


@register("_shuffle", input_names=("data",), differentiable=False,
          aliases=("shuffle",))
def _shuffle(p, data):
    """data with its rows (axis 0) in a random order."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=_random.generator(
        data.device), device=data.device)
    return data[perm]


def _sample_op(name, input_names):
    """Register ``_sample_<name>``: ``draw(shape, bshape, params, gen)``
    gives ``params[0].shape + shape`` float32 samples, each parameter
    reshaped to ``bshape`` so that it broadcasts over its samples."""
    def deco(draw):
        @register("_sample_" + name, input_names=input_names,
                  differentiable=False, args=list(_SAMPLE_ARGS),
                  aliases=("sample_" + name,))
        def op(p, *params):
            first = params[0]
            shape = tuple(first.shape) + tuple(p["shape"])
            bshape = tuple(first.shape) + (1,) * len(p["shape"])
            return _draw(shape, p["dtype"], first.device, lambda gen: draw(
                shape, [t.reshape(bshape) for t in params], gen))
        op.__doc__ = draw.__doc__
        return draw
    return deco


@_sample_op("uniform", ("low", "high"))
def _sample_uniform(shape, params, gen):
    """Uniform on [low, high) per element."""
    low, high = params
    return low + torch.rand(shape, generator=gen, device=low.device) * (
        high - low)


@_sample_op("normal", ("mu", "sigma"))
def _sample_normal(shape, params, gen):
    """Normal with mean mu and standard deviation sigma per element."""
    mu, sigma = params
    return mu + torch.randn(shape, generator=gen, device=mu.device) * sigma


@_sample_op("gamma", ("alpha", "beta"))
def _sample_gamma(shape, params, gen):
    """Gamma with shape alpha and scale beta per element."""
    alpha, beta = params
    return _gamma(alpha.float().expand(shape).contiguous(), gen) * beta


@_sample_op("exponential", ("lam",))
def _sample_exponential(shape, params, gen):
    """Exponential with rate lam per element."""
    lam, = params
    return _exp(shape, lam.device, gen) / lam


@_sample_op("poisson", ("lam",))
def _sample_poisson(shape, params, gen):
    """Poisson with rate lam per element."""
    lam, = params
    return torch.poisson(lam.float().expand(shape).contiguous(),
                         generator=gen)


@_sample_op("negative_binomial", ("k", "p"))
def _sample_negative_binomial(shape, params, gen):
    """NB(k, p) = Poisson(Gamma(k, (1-p)/p)) per element."""
    k, prob = params
    lam = _gamma(k.float().expand(shape).contiguous(), gen) * (
        (1 - prob) / prob)
    return torch.poisson(lam, generator=gen)


@_sample_op("generalized_negative_binomial", ("mu", "alpha"))
def _sample_gen_negative_binomial(shape, params, gen):
    """GNB(mu, alpha) = Poisson(Gamma(1/alpha, mu*alpha)) per element."""
    mu, alpha = params
    inv_a = 1.0 / torch.clamp(alpha.float(), min=1e-12)
    lam = _gamma(inv_a.expand(shape).contiguous(), gen) * (mu * alpha)
    return torch.poisson(lam, generator=gen)
