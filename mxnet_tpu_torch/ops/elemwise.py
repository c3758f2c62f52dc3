"""Elementwise operators: the tensor arithmetic of the serving slice.

The counterpart of part of ``mxnet_tpu/ops/elemwise.py``: binary broadcast
ops with their ``elemwise_*`` aliases and the scalar variants.  Inside
blocks the same arithmetic is written with Python operators on
``torch.Tensor``, which broadcast the same way.
"""
from __future__ import annotations

import torch

from ..base import Arg
from .registry import register

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
