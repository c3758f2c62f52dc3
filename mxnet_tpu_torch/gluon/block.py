"""gluon Block / HybridBlock (parity: python/mxnet/gluon/block.py).

A ``Block`` is a ``torch.nn.Module`` with MXNet's naming: name scopes and
prefixes, ``collect_params``, ``initialize(ctx=)``, ``cast`` and
``save_params`` / ``load_params``.  Children
live in ``_modules`` (attribute name, or their index when added with
``register_child``).  ``HybridBlock.forward`` calls
``hybrid_forward(F, x, *args, **params)`` with ``F`` the port's ``nd``
namespace.  ``hybridize()`` sets the flag and the block keeps running
eagerly with the same numbers; symbol tracing and CUDA graphs come later.

Deferred initialization: a parameter whose shape has unknown (0)
dimensions is resolved by its own block from the first input it sees
(``_infer_param_shapes``), in the order the forward reaches the blocks.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import torch

from ..base import MXNetError
from .. import ndarray as nd
from .parameter import Parameter, ParameterDict


class _BlockScope:
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..name import NameManager
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        from ..name import Prefix
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


class Block(torch.nn.Module):
    """Base building block (parity: gluon/block.py Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)

    @property
    def _children(self) -> List["Block"]:
        return list(self._modules.values())

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self) -> ParameterDict:
        return self._params

    def collect_params(self) -> ParameterDict:
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for cld in self._children:
            ret.update(cld.collect_params())
        return ret

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def initialize(self, init=None, ctx=None, force_reinit=False):
        self.collect_params().initialize(init, ctx, force_reinit)

    def save_params(self, filename):
        """Write the parameters, named relative to this block's prefix; the
        JAX package's ``load_params`` reads the file, and the reverse."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing, ignore_extra,
                                   self.prefix)

    def hybridize(self, active=True):
        for cld in self._children:
            cld.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Parity: gluon/block.py HybridBlock, run eagerly."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._reg_params: Dict[str, Parameter] = {}
        self._active = False

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            value._attach(self, name)
            object.__setattr__(self, name, value)
            return
        if isinstance(value, torch.nn.Module) and \
                not isinstance(value, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but "
                f"{value} has type {type(value)}.")
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but "
                f"{block} has type {type(block)}.")
        super().register_child(block, name)

    def hybridize(self, active=True):
        self._active = active
        super().hybridize(active)

    def _infer_param_shapes(self, x, *args):
        """Fix the unknown dimensions of this block's own parameters from
        its first input; blocks with deferred parameters override this."""
        raise MXNetError(
            f"{self.name}: cannot infer the shapes of its deferred "
            f"parameters {sorted(self._reg_params)}")

    def forward(self, x, *args):
        if any(p.is_deferred for p in self._reg_params.values()):
            self._infer_param_shapes(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
        params = {name: p.data() for name, p in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
