"""Elementwise operators: the unary table, binary broadcast ops, their
scalar variants, ``Cast``, ``BlockGrad`` and ``make_loss``.

The counterpart of part of ``mxnet_tpu/ops/elemwise.py``: the unary table
(``floor`` among it, which beam search uses), binary broadcast ops with
their ``elemwise_*`` aliases and the ``_power``/``_maximum``/... names
Symbol graphs use, and the scalar variants.  Inside blocks the same
arithmetic is written with Python operators on ``torch.Tensor``, which
broadcast the same way (on Symbols, the operators build these ops).
"""
from __future__ import annotations

import torch

from ..base import Arg, torch_dtype
from .registry import register


# ---------------------------------------------------------------------------
# Unary ops: one torch function per entry of the JAX package's table
# ---------------------------------------------------------------------------
def _softrelu(x):
    if not x.is_floating_point():    # the JAX package's x64 promotion
        x = x.to(torch.float64)
    return torch.logaddexp(x, torch.zeros_like(x))


def _maximum(x, s):
    """max(x, s) for a Python number s, as ``jnp.maximum``: at a tie the
    gradient is split half and half (``torch.clamp`` gives all of it to
    x).  s rides as a 0-dim CPU tensor, which adds no device kernel."""
    return torch.maximum(x, torch.tensor(s, dtype=torch.result_type(x, s)))


def _minimum(x, s):
    """min(x, s), the ties split as in ``_maximum``."""
    return torch.minimum(x, torch.tensor(s, dtype=torch.result_type(x, s)))


def _abs(x):
    """|x| with the gradient 1 at 0, as ``jnp.abs`` (``torch.abs``
    gives 0)."""
    return torch.where(x >= 0, x, -x)


def _hypot(a, b):
    """hypot in float32 for integer inputs, as the JAX package gives."""
    if not (a.is_floating_point() or b.is_floating_point()):
        a, b = a.float(), b.float()
    return torch.hypot(a, b)


def _softsign(x):
    return x / (1 + torch.abs(x))


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _logical_not(x):
    return (x == 0).to(x.dtype if x.is_floating_point() else torch.float32)


_UNARY = {
    "relu": lambda x: _maximum(x, 0),
    "sigmoid": torch.sigmoid,
    "softsign": _softsign,
    "negative": torch.neg,
    "reciprocal": lambda x: 1.0 / x,
    "abs": _abs,
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


@register("BlockGrad", input_names=("data",), aliases=("stop_gradient",))
def _block_grad(p, x):
    """Parity: src/operator/tensor/elemwise_unary_op.cc BlockGrad."""
    return x.detach()


@register("make_loss", input_names=("data",))
def _make_loss_op(p, x):
    return x

def _bool_out(f):
    return lambda a, b: f(a, b).to(torch.result_type(a, b))


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": _hypot,
    "equal": _bool_out(torch.eq),
}

_ELEMWISE_ALIAS = {"add": ("elemwise_add", "_plus"), "sub": ("elemwise_sub", "_minus"),
                   "mul": ("elemwise_mul",), "div": ("elemwise_div",),
                   # the names the Symbol free functions and graph files use
                   # (the JAX package's ops/compat.py aliases)
                   "power": ("_power",), "maximum": ("_maximum",),
                   "minimum": ("_minimum",), "hypot": ("_hypot",),
                   "equal": ("_equal",)}

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
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": _maximum,
    "_minimum_scalar": _minimum,
    "_hypot_scalar": lambda x, s: _hypot(x, torch.full_like(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
}

for _name, _f in _SCALAR.items():
    register(_name, input_names=("data",), args=[Arg("scalar", float, required=True)])(
        (lambda f: lambda p, x: f(x, p["scalar"]))(_f))


@register("Cast", input_names=("data",), aliases=("cast",),
          args=[Arg("dtype", str, required=True)])
def _cast(p, x):
    return x.to(torch_dtype(p["dtype"]))
