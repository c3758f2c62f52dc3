"""gluon.Parameter / ParameterDict (parity: python/mxnet/gluon/parameter.py).

A ``Parameter`` carries the MXNet name, shape, dtype and initializer, and
wraps one ``torch.nn.Parameter`` holding its data on one device.  Every
HybridBlock that holds the Parameter as an attribute also sees that tensor
in its own ``_parameters``, so ``named_parameters()`` and ``state_dict()``
work as on any ``nn.Module``.  Initialization may be deferred until the
first forward, which fixes the unknown dimensions from the input.
``ParameterDict.save`` / ``load`` read and write the JAX package's
``.params`` files (``nd.save``'s ``.npz`` container, names relative to a
prefix), so a checkpoint moves between the two packages either way.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as _np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, as_device, current_context
from .. import initializer
from ..initializer import InitDesc


class DeferredInitializationError(MXNetError):
    pass


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype=_np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self._data = None
        self._var = None
        self._ctx = None
        self._deferred_init = ()
        self._owners = []          # (block, attribute name) pairs
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = np_dtype(dtype)
        # gradients arrive with the training slice; the tensor is created
        # with requires_grad=False so that serving builds no autograd graph
        self.grad_req = grad_req if differentiable else "null"
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"

    @property
    def is_deferred(self) -> bool:
        return self._data is None and bool(self._deferred_init)

    def _set_data(self, tensor: torch.Tensor) -> None:
        self._data = torch.nn.Parameter(tensor, requires_grad=False)
        for block, attr in self._owners:
            block._parameters[attr] = self._data

    def _attach(self, block, attr: str) -> None:
        self._owners.append((block, attr))
        if self._data is not None:
            block._parameters[attr] = self._data

    def _load_init(self, data, ctx):
        if self.shape and _np.prod(self.shape) > 0:
            for self_dim, data_dim in zip(self.shape, data.shape):
                if self_dim not in (0, data_dim):
                    raise MXNetError(
                        f"Failed loading Parameter {self.name}: shape mismatch "
                        f"{self.shape} vs {tuple(data.shape)}")
        self.shape = tuple(data.shape)
        if isinstance(ctx, Context):
            ctx = [ctx]
        self._deferred_init = ()
        self._init_impl(data, ctx)

    def _home_ctx(self):
        """Where loaded data lands: the context this parameter was
        initialized or deferred with, else the current context."""
        if self._data is not None or self._deferred_init:
            return self.list_ctx()[0]
        return current_context()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = ()
        if self.shape is None or _np.prod(self.shape) <= 0:
            raise MXNetError(
                f"Cannot initialize Parameter {self.name} because it has "
                f"invalid shape: {self.shape}.")
        # drawn on the host, moved to the device once
        data = torch.zeros(self.shape, dtype=torch_dtype(self.dtype))
        initializer.create(default_init)(
            InitDesc(self.name, {"__init__": init}), data)
        self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        self._ctx = list(ctx_list)
        if not isinstance(data, torch.Tensor):
            from ..ndarray import array
            data = array(data, ctx="cpu", dtype=self.dtype)
        self._set_data(data.detach().to(device=as_device(self._ctx[0]),
                                        dtype=torch_dtype(self.dtype)))

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if default_init is None:
            default_init = initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, (Context, torch.device, str)):
            ctx = [ctx]
        as_device(ctx[0])  # a gpu context with no CUDA device raises here
        if init is None:
            init = default_init if self.init is None else self.init
        if self.shape is None or any(d == 0 for d in self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(f"Cannot initialize Parameter {self.name} "
                             "because it has invalid shape.")
        self._deferred_init = (init, ctx, default_init)
        self._finish_deferred_init()

    def data(self, ctx=None) -> torch.Tensor:
        if self._data is not None:
            return self._data
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter {self.name} has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass.")
        raise MXNetError(
            f"Parameter {self.name} has not been initialized. You should "
            "initialize parameters with Block.collect_params().initialize()")

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise MXNetError(f"Parameter {self.name} has not been initialized")
        return self._ctx

    def var(self):
        """This parameter as a Symbol variable (made once), carrying its
        shape, dtype, lr/wd multipliers and initializer as attributes."""
        from .. import symbol
        if self._var is None:
            self._var = symbol.Variable(self.name, shape=self.shape,
                                        dtype=self.dtype, lr_mult=self.lr_mult,
                                        wd_mult=self.wd_mult, init=self.init)
        return self._var

    def cast(self, dtype):
        self.dtype = np_dtype(dtype)
        if self._data is None:
            return
        self._set_data(self._data.detach().to(torch_dtype(self.dtype)))


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    def __repr__(self):
        s = "\n".join(repr(v) for v in self.values())
        return f"ParameterDict '{self._prefix}' (\n{s}\n)"

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs) -> Parameter:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if getattr(param, k, None) is not None and v is not None:
                    existing = getattr(param, k)
                    if k == "shape" and len(v) == len(existing):
                        param.shape = tuple(vi if vi != 0 else ei
                                            for vi, ei in zip(v, existing))
                else:
                    setattr(param, k, v)
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise MXNetError(
                        f"Cannot update because duplicate Parameter '{k}'")
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to ``filename`` (``nd.save``'s container),
        named without ``strip_prefix``."""
        from ..ndarray import save
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(f"Prefix '{strip_prefix}' is to be stripped "
                                 f"but Parameter's name '{param.name}' does "
                                 "not start with it")
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load ``filename`` into these parameters, each name prefixed with
        ``restore_prefix``.  The data lands on ``ctx`` when given, else on
        each parameter's own context (the current one for a parameter
        never initialized)."""
        from ..ndarray.ndarray import load_numpy
        loaded = load_numpy(filename)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename} holds no named parameters")
        arg_dict = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError(f"Parameter {name} is missing in file "
                                     f"{filename}")
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(f"Parameter {name} loaded from "
                                     f"{filename} is not present in "
                                     "ParameterDict")
                continue
            param = self[name]
            param._load_init(value, param._home_ctx() if ctx is None else ctx)
