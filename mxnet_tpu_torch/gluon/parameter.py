"""gluon.Parameter / ParameterDict (parity: python/mxnet/gluon/parameter.py).

A ``Parameter`` carries the MXNet name, shape, dtype, initializer and
``grad_req``, and wraps one ``torch.nn.Parameter`` holding its data on one
device.  That tensor is an autograd variable (``autograd.mark_variable``)
unless ``grad_req`` is "null"; a Block runs with torch's grad mode set to
``autograd.is_recording()``, so outside ``record()`` no graph is built
through it.  Its gradient buffer is the tensor's ``.grad``, allocated by
the first backward that reaches it (or by ``grad()``).  Every
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
from .. import autograd, initializer
from ..initializer import InitDesc
from ..observability import memory as _memory


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
        self._grad_req = None
        self._differentiable = differentiable
        self.grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"

    def __getstate__(self):
        """What ``Updater.get_states(dump_optimizer=True)`` pickles through
        the optimizer's ``param_dict``: the reference's attribute names
        without the data (a loading Trainer points ``param_dict`` back at
        its live parameters), the owning blocks or the symbol variable, and
        the dtype by name (bfloat16's numpy dtype needs ml_dtypes)."""
        state = self.__dict__.copy()
        state.update(_data=None, _var=None, _owners=[],
                     dtype=np_dtype(self.dtype).name)
        return state

    def __setstate__(self, state):
        """Also a reference Parameter's ``__dict__``: its ``_data`` and
        ``_grad`` arrays are dropped, and it gains the port's
        ``_owners``."""
        state = dict(state, _data=None, _var=None, _owners=[])
        state.pop("_grad", None)
        try:
            state["dtype"] = np_dtype(state.get("dtype"))
        except (MXNetError, TypeError):
            pass
        self.__dict__.update(state)

    @property
    def is_deferred(self) -> bool:
        return self._data is None and bool(self._deferred_init)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """A parameter made with ``differentiable=False`` (BatchNorm's
        moving statistics) stays at "null" whatever is asked."""
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be one of 'write', 'add', or "
                             f"'null', but got '{req}'")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._data is not None:
            autograd.mark_variable(self._data, None, req)

    def _set_data(self, tensor: torch.Tensor) -> None:
        # only floating-point tensors can carry gradients in torch
        req = self._grad_req if tensor.is_floating_point() else "null"
        self._data = torch.nn.Parameter(tensor, requires_grad=req != "null")
        if _memory.ENABLED:
            # the memory ledger: a parameter is born (or replaced) here;
            # ``_memory_tag`` lets a subsystem claim its own row
            _memory.register(self._data,
                             tag=getattr(self, "_memory_tag", "param"))
        autograd.mark_variable(self._data, None, req)
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

    def set_data(self, data):
        """Replace the value with ``data`` (a tensor, array or list), cast to
        this parameter's dtype.  An initialized parameter is written in
        place on its device; a deferred one takes ``data`` as its
        initial value, and its shape from it."""
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(_np.asarray(data))
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError(f"Parameter {self.name} has not been "
                                 "initialized")
            ctx = self._deferred_init[1]
            self.shape = tuple(data.shape)
            self._deferred_init = ()
            self._init_impl(data, ctx)
            return
        with torch.no_grad():
            self._data.copy_(data.reshape(self._data.shape))

    def list_data(self):
        return [self.data()]

    def reset_ctx(self, ctx):
        """Move the data to ``ctx`` (a context, or a list of them whose first
        is used), as ``.to(device)``; a deferred parameter will initialize
        there.  A ``gpu`` context with no CUDA device raises."""
        if isinstance(ctx, (Context, torch.device, str)):
            ctx = [ctx]
        device = as_device(ctx[0])
        if self._data is not None:
            self._ctx = list(ctx)
            self._set_data(self._data.detach().to(device))
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, list(ctx), default_init)
        else:
            raise ValueError(f"Cannot reset context for Parameter "
                             f"{self.name} because it has not been "
                             "initialized.")

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

    def grad(self, ctx=None) -> torch.Tensor:
        """The gradient buffer (zeros until a backward reaches it)."""
        data = self.data()
        if self._grad_req == "null":
            raise MXNetError(f"Cannot get gradient array for Parameter "
                             f"{self.name} because grad_req='null'")
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(data)
        return self._data.grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._data is not None and self._data.grad is not None:
            self._data.grad.zero_()

    @property
    def fresh_grad(self) -> bool:
        """True when a backward has deposited into this parameter's
        gradient since the last Trainer step cleared the mark (the
        stale-gradient check reads it)."""
        return self._data is not None and self._data._mx_fresh_grad

    @fresh_grad.setter
    def fresh_grad(self, value: bool):
        self._data._mx_fresh_grad = bool(value)

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


class Constant(Parameter):
    """A parameter that holds ``value`` and takes no gradient (grad_req
    "null"); initializing it copies the value, whatever the initializer."""

    def __init__(self, name, value):
        if not isinstance(value, torch.Tensor):
            from ..ndarray import array
            value = array(value, ctx="cpu")    # a host copy until initialized
        self.value = value

        class _Init(initializer.Initializer):
            def _init_weight(self, _, arr):
                arr.copy_(value)

            _init_default = _init_weight

        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=str(value.dtype).replace("torch.", ""),
                         init=_Init())


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

    def get_constant(self, name, value=None) -> Constant:
        """The constant ``prefix + name``, made from ``value`` when this dict
        (or the one it shares) has none."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'.")
            param = Constant(name, value)
            self._params[name] = param
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

    def zero_grad(self):
        """Set every parameter's gradient to zero."""
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` of every parameter to ``value`` (e.g.
        ``grad_req``)."""
        for p in self.values():
            setattr(p, name, value)

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
