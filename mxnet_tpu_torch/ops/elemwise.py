"""Elementwise operators: the unary table, binary broadcast ops and their
scalar variants.

The counterpart of part of ``mxnet_tpu/ops/elemwise.py``: the unary table
(``floor`` among it, which beam search uses), binary broadcast ops with
their ``elemwise_*`` aliases and the scalar variants.  Inside blocks the
same arithmetic is written with Python operators on ``torch.Tensor``, which
broadcast the same way.
"""
from __future__ import annotations

import torch

from ..base import Arg
from .registry import register


# ---------------------------------------------------------------------------
# Unary ops: one torch function per entry of the JAX package's table
# ---------------------------------------------------------------------------
def _softrelu(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _softsign(x):
    return x / (1 + torch.abs(x))


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _logical_not(x):
    return (x == 0).to(x.dtype if x.is_floating_point() else torch.float32)


_UNARY = {
    "relu": lambda x: torch.clamp(x, min=0),
    "sigmoid": torch.sigmoid,
    "softsign": _softsign,
    "negative": torch.neg,
    "reciprocal": lambda x: 1.0 / x,
    "abs": torch.abs,
    "sign": torch.sign,
    "round": torch.round,          # half to even, as jnp.round
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "logical_not": _logical_not,
}

for _name, _f in _UNARY.items():
    register(_name, input_names=("data",))(
        (lambda f: lambda p, x: f(x))(_f))

register("softrelu", input_names=("data",))(lambda p, x: _softrelu(x))

_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
}

_ELEMWISE_ALIAS = {"add": ("elemwise_add", "_plus"), "sub": ("elemwise_sub", "_minus"),
                   "mul": ("elemwise_mul",), "div": ("elemwise_div",)}

for _name, _f in _BINARY.items():
    register("broadcast_" + _name, input_names=("lhs", "rhs"),
             aliases=_ELEMWISE_ALIAS.get(_name, ()))(
        (lambda f: lambda p, a, b: f(a, b))(_f))

# scalar variants (parity: *_scalar ops)
_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
}

for _name, _f in _SCALAR.items():
    register(_name, input_names=("data",), args=[Arg("scalar", float, required=True)])(
        (lambda f: lambda p, x: f(x, p["scalar"]))(_f))
