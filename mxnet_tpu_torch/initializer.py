"""Weight initializers (parity: python/mxnet/initializer.py).

The counterpart of ``mxnet_tpu/initializer.py``: the same dispatch on the
parameter's name and the same draws from ``random.host_rng`` in the same
order, so one seed gives the same parameters in both packages.  The port
carries Zero, One, Uniform, Normal and Xavier.
"""
from __future__ import annotations

import json

import numpy as _np
import torch

from .base import MXNetError, Registry
from .random import host_rng as _host_rng

_REG = Registry("initializer")
register = _REG.register


def _fill(arr: torch.Tensor, value) -> None:
    """arr[:] = value, for a scalar or a numpy array (float64 draws round to
    the parameter's dtype once, as the JAX package's setitem does)."""
    if isinstance(value, (int, float)):
        arr.fill_(value)
    else:
        arr.copy_(torch.from_numpy(_np.asarray(value)))


class InitDesc(str):
    """Parameter name + attrs descriptor (parity: initializer.InitDesc)."""

    def __new__(cls, name, attrs=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        return obj


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        """The JSON a Symbol variable's ``__init__`` attribute carries."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr) -> None:
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init_attr = desc.attrs.get("__init__")
        if init_attr:
            create(init_attr)._init_weight(desc, arr)
            return
        name = str(desc)
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_bias(self, desc, arr):
        _fill(arr, 0.0)

    def _init_gamma(self, desc, arr):
        _fill(arr, 1.0)

    def _init_beta(self, desc, arr):
        _fill(arr, 0.0)

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_default(self, desc, arr):
        self._init_weight(desc, arr)


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        _fill(arr, 0.0)


_REG._map["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, desc, arr):
        _fill(arr, 1.0)


_REG._map["ones"] = One


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        _fill(arr, _host_rng.uniform(-self.scale, self.scale, tuple(arr.shape)))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        _fill(arr, _host_rng.normal(0.0, self.sigma, tuple(arr.shape)))


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = tuple(arr.shape)
        hw_scale = 1.0
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim>=2, got {shape} for {desc}")
        if len(shape) > 2:
            hw_scale = _np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = _np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _fill(arr, _host_rng.uniform(-scale, scale, shape))
        else:
            _fill(arr, _host_rng.normal(0, scale, shape))


def create(name, *args, **kwargs) -> Initializer:
    if isinstance(name, Initializer):
        return name
    return _REG.get(name)(*args, **kwargs)


class init:
    """`mx.init.*` alias namespace (parity: mxnet.initializer as mx.init)."""
    Initializer = Initializer
    InitDesc = InitDesc
    Zero = Zero
    One = One
    Uniform = Uniform
    Normal = Normal
    Xavier = Xavier
