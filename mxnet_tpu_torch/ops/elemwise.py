"""Elementwise operators: the unary table, binary broadcast ops (the
arithmetic, comparisons and logical ones), their scalar variants,
``clip``, ``_copy``, ``add_n``, ``smooth_l1``, ``Cast``, ``BlockGrad`` and
``make_loss``.

The counterpart of ``mxnet_tpu/ops/elemwise.py``: the unary table
(``floor`` among it, which beam search uses), binary broadcast ops with
their ``elemwise_*`` aliases and the ``_power``/``_maximum``/``_greater``/
... names Symbol graphs use (the JAX package's ops/compat.py aliases), and
the scalar variants.  Comparisons and logical ops return 1.0/0.0 in the
inputs' dtype, not bool.  ``mod`` takes the divisor's sign, as
``jnp.mod`` (``torch.remainder``).  Inside blocks the same arithmetic is
written with Python operators on ``torch.Tensor``, which broadcast the
same way (on Symbols, the operators build these ops); the comparison
operators of ``torch.Tensor`` return bool, the ``nd`` functions MXNet's
1.0/0.0.

Where ``jnp`` and ``torch`` differ in a gradient the op follows ``jnp``:
ties of max/min split half and half (``relu``, ``clip``), ``abs`` has
gradient 1 at 0, ``hypot`` 0.5 for each input at (0, 0), ``power``'s
gradient in the base is NaN at 0**0 (``y * x**(y-1)``), ``cbrt``'s is
+inf at 0.
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


def _scalar(x, s):
    """The Python number s as a 0-dim CPU tensor of x's result type: it
    takes part in an op on x as a tensor operand (with a gradient formula
    where torch has one only for two tensors) and adds no device kernel."""
    return torch.tensor(s, dtype=torch.result_type(x, s))


def _maximum(x, s):
    """max(x, s) for a Python number s, as ``jnp.maximum``: at a tie the
    gradient is split half and half (``torch.clamp`` gives all of it to
    x)."""
    return torch.maximum(x, _scalar(x, s))


def _minimum(x, s):
    """min(x, s), the ties split as in ``_maximum``."""
    return torch.minimum(x, _scalar(x, s))


def _abs(x):
    """|x| with the gradient 1 at 0, as ``jnp.abs`` (``torch.abs``
    gives 0)."""
    return torch.where(x >= 0, x, -x)


class _HypotFn(torch.autograd.Function):
    """``torch.hypot`` with ``jnp.hypot``'s gradient: a / hypot(a, b), 0.5
    for each input where both are 0 (``jnp.hypot`` is a max of the two
    magnitudes there, whose tie splits) and 0 where the result is
    infinite (``torch.hypot``'s is NaN at both)."""

    @staticmethod
    def forward(ctx, a, b):
        h = torch.hypot(a, b)
        ctx.save_for_backward(a, b, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, b, h = ctx.saved_tensors
        dead = torch.isinf(h)

        def grad(x, need):
            if not need:
                return None
            d = torch.where(h == 0, 0.5, x / h).masked_fill(dead, 0.0)
            return (g * d).sum_to_size(x.shape)
        return grad(a, ctx.needs_input_grad[0]), grad(b, ctx.needs_input_grad[1])


def _hypot(a, b):
    """hypot in float32 for integer inputs, as the JAX package gives."""
    if not (a.is_floating_point() or b.is_floating_point()):
        a, b = a.float(), b.float()
    return _HypotFn.apply(a, b)


class _PowFn(torch.autograd.Function):
    """``torch.pow`` with ``jnp.power``'s gradients: ``y * x**(y-1)`` in the
    base, NaN at 0**0 (``torch.pow`` masks exponent 0 to a gradient of
    0), and ``x**y * log(x)`` in the exponent with log(0) read as 0.
    ``b`` may be a Python number (``_power_scalar``)."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.pow(a, b)
        ctx.save_for_backward(a, out, *((b,) if torch.is_tensor(b) else ()))
        ctx.exponent = None if torch.is_tensor(b) else b
        return out

    @staticmethod
    def backward(ctx, g):
        a, out, *rest = ctx.saved_tensors
        b = rest[0] if rest else ctx.exponent
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g * b * torch.pow(a, b - 1)).sum_to_size(a.shape)
        if rest and ctx.needs_input_grad[1]:
            gb = (g * out * torch.log(torch.where(a == 0, 1.0, a))
                  ).sum_to_size(b.shape)
        return ga, gb


def _power(a, b):
    return _PowFn.apply(a, b)


def _softsign(x):
    return x / (1 + torch.abs(x))


class _CbrtFn(torch.autograd.Function):
    """The real cube root, with ``jnp.cbrt``'s gradient ``1 / (3 cbrt(x)**2)``:
    +inf at 0, where the product rule through ``sign(x) * |x|**(1/3)``
    gives NaN."""

    @staticmethod
    def forward(ctx, x):
        # copysign keeps -0's sign, so 1 / cbrt(-0.0) is -inf as in jnp
        out = torch.copysign(torch.abs(x) ** (1.0 / 3.0), x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return g / (3.0 * out * out)


def _cbrt(x):
    return _CbrtFn.apply(x)


class _LgammaFn(torch.autograd.Function):
    """``lgamma`` with ``jsp.gammaln``'s gradient: digamma, but NaN at ±0
    where ``torch.digamma`` gives -inf."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.lgamma(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        d = torch.digamma(x)
        return g * torch.where(x == 0, torch.full_like(d, float("nan")), d)


def _lgamma(x):
    return _LgammaFn.apply(x) if x.is_floating_point() else torch.lgamma(x)


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
    "gamma": lambda x: torch.exp(_lgamma(x)),
    "gammaln": _lgamma,
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


@register("_copy", input_names=("data",), aliases=("identity",))
def _copy(p, x):
    """A new tensor with x's values (the JAX package's arrays are values;
    a torch op that returned x would alias it)."""
    return x.clone()


@register("BlockGrad", input_names=("data",), aliases=("stop_gradient",))
def _block_grad(p, x):
    """Parity: src/operator/tensor/elemwise_unary_op.cc BlockGrad."""
    return x.detach()


@register("make_loss", input_names=("data",))
def _make_loss_op(p, x):
    return x


@register("clip", input_names=("data",),
          args=[Arg("a_min", float, required=True),
                Arg("a_max", float, required=True)])
def _clip(p, x):
    """min(max(x, a_min), a_max), as ``jnp.clip``: at either bound the
    gradient is 0.5 (``torch.clamp`` gives 1)."""
    return _minimum(_maximum(x, p["a_min"]), p["a_max"])


def _bool_out(f):
    return lambda a, b: f(a, b).to(torch.result_type(a, b))


def _logical(f):
    return _bool_out(lambda a, b: f(a != 0, b != 0))


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": torch.remainder,
    "power": _power,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": _hypot,
    "equal": _bool_out(torch.eq),
    "not_equal": _bool_out(torch.ne),
    "greater": _bool_out(torch.gt),
    "greater_equal": _bool_out(torch.ge),
    "lesser": _bool_out(torch.lt),
    "lesser_equal": _bool_out(torch.le),
    "logical_and": _logical(torch.logical_and),
    "logical_or": _logical(torch.logical_or),
    "logical_xor": _logical(torch.logical_xor),
}

_ELEMWISE_ALIAS = {"add": ("elemwise_add", "_plus"), "sub": ("elemwise_sub", "_minus"),
                   "mul": ("elemwise_mul",), "div": ("elemwise_div",),
                   # the names the Symbol free functions and graph files use
                   # (the JAX package's ops/compat.py aliases)
                   "power": ("_power",), "maximum": ("_maximum",),
                   "minimum": ("_minimum",), "hypot": ("_hypot",),
                   "equal": ("_equal",), "not_equal": ("_not_equal",),
                   "greater": ("_greater",),
                   "greater_equal": ("_greater_equal",),
                   "lesser": ("_lesser",), "lesser_equal": ("_lesser_equal",),
                   "mod": ("_mod",)}

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
    "_mod_scalar": torch.remainder,
    "_rmod_scalar": lambda x, s: torch.remainder(_scalar(x, s), x),
    "_power_scalar": _power,
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": _maximum,
    "_minimum_scalar": _minimum,
    "_hypot_scalar": lambda x, s: _hypot(x, torch.full_like(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
}

for _name, _f in _SCALAR.items():
    register(_name, input_names=("data",), args=[Arg("scalar", float, required=True)])(
        (lambda f: lambda p, x: f(x, p["scalar"]))(_f))


@register("add_n", input_names=("args",), variadic=True,
          aliases=("ElementWiseSum", "_sum"))
def _add_n(p, *xs):
    """The sum of every input, added left to right as the JAX package adds
    them (parity: src/operator/tensor/elemwise_sum.cc)."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register("smooth_l1", input_names=("data",), args=[Arg("scalar", float, 1.0)])
def _smooth_l1(p, x):
    """0.5 s^2 x^2 where |x| < 1/s^2, else |x| - 0.5/s^2."""
    s2 = p["scalar"] ** 2
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       absx - 0.5 / s2)


@register("Cast", input_names=("data",), aliases=("cast",),
          args=[Arg("dtype", str, required=True)])
def _cast(p, x):
    return x.to(torch_dtype(p["dtype"]))
