"""Weight initializers (parity: python/mxnet/initializer.py).

The counterpart of ``mxnet_tpu/initializer.py``: the same dispatch on the
parameter's name and the same draws from ``random.host_rng`` in the same
order, so one seed gives the same parameters in both packages: Zero, One,
Constant, Uniform, Normal, Orthogonal, Xavier, MSRAPrelu, Bilinear,
LSTMBias, FusedRNN (which delegates to an inner initializer), and the
pattern dispatch ``Mixed`` and ``Load`` from saved arrays.
"""
from __future__ import annotations

import json
import re

import numpy as _np
import torch

from .base import MXNetError, Registry
from .random import host_rng as _host_rng

_REG = Registry("initializer")
register = _REG.register


def _fill(arr: torch.Tensor, value) -> None:
    """arr[:] = value, for a scalar, a tensor or an array (float64 draws
    round to the parameter's dtype once, as the JAX package's setitem
    does)."""
    if isinstance(value, (int, float)):
        arr.fill_(value)
    elif isinstance(value, torch.Tensor):
        arr.copy_(value)
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
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        """Kept as the JAX package keeps it: stored, nothing prints."""
        self._verbose = verbose
        self._print_func = print_func
        return self

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
        elif "moving_mean" in name or "running_mean" in name \
                or "moving_avg" in name:
            self._init_zero(desc, arr)
        elif "moving_var" in name or "running_var" in name:
            self._init_one(desc, arr)
        elif name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_zero(self, desc, arr):
        _fill(arr, 0.0)

    def _init_one(self, desc, arr):
        _fill(arr, 1.0)

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
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        _fill(arr, self.value)


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
class Orthogonal(Initializer):
    """A scaled orthonormal basis from the SVD of a uniform or normal draw
    of (rows, product of the other axes)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _host_rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _host_rng.normal(0.0, 1.0, (nout, nin))
        u, _, v = _np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _fill(arr, (self.scale * q).reshape(tuple(arr.shape)))


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


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel, for a Deconvolution's weight."""

    def _init_weight(self, desc, arr):
        shape = tuple(arr.shape)
        weight = _np.zeros(int(_np.prod(shape)), dtype="float32")
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _fill(arr, weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """The forget gate's bias (the second quarter) ``forget_bias``, the
    rest 0."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = _np.zeros(tuple(arr.shape), dtype="float32")
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        _fill(arr, b)

    _init_default = _init_weight


@register
class FusedRNN(Initializer):
    """A fused RNN's packed parameter vector, initialized by delegating to
    an inner initializer under the name with "parameters" read as
    "weight"."""

    def __init__(self, init, num_hidden, num_layers, mode, bidirectional=False,
                 forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(init=init.dumps() if init else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._mode = mode

    def _init_weight(self, desc, arr):
        self._init(InitDesc(str(desc).replace("parameters", "weight")), arr)

    _init_default = _init_weight


class Mixed:
    """The first initializer whose pattern matches the parameter's name
    (``re.match``)."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError(f"no initializer pattern matches parameter {name}")


class Load:
    """Values from a dict of saved arrays (``arg:``/``aux:`` prefixes
    dropped), ``default_init`` for names it lacks."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        name = str(name)
        if name in self.param:
            _fill(arr, self.param[name])
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise MXNetError(f"parameter {name} not found in loaded params")


def create(name, *args, **kwargs) -> Initializer:
    """An initializer from an instance, a registered name, or the JSON that
    ``dumps`` writes."""
    if isinstance(name, Initializer):
        return name
    if isinstance(name, str) and name.startswith("["):
        cls_name, kw = json.loads(name)
        return _REG.get(cls_name)(**kw)
    return _REG.get(name)(*args, **kwargs)


class init:
    """`mx.init.*` alias namespace (parity: mxnet.initializer as mx.init)."""
    Initializer = Initializer
    InitDesc = InitDesc
    Zero = Zero
    One = One
    Constant = Constant
    Uniform = Uniform
    Normal = Normal
    Orthogonal = Orthogonal
    Xavier = Xavier
    MSRAPrelu = MSRAPrelu
    Bilinear = Bilinear
    LSTMBias = LSTMBias
    FusedRNN = FusedRNN
    Mixed = Mixed
    Load = Load
