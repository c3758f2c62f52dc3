"""gluon Block / HybridBlock / SymbolBlock (parity: python/mxnet/gluon/block.py).

A ``Block`` is a ``torch.nn.Module`` with MXNet's naming: name scopes and
prefixes, ``collect_params``, ``initialize(ctx=)``, ``cast`` and
``save_params`` / ``load_params``.  Children
live in ``_modules`` (attribute name, or their index when added with
``register_child``).  ``HybridBlock.forward`` calls
``hybrid_forward(F, x, *args, **params)``: with ``F`` the port's ``nd``
namespace on tensors, or with ``F`` the ``sym`` namespace when ``x`` is a
Symbol, which traces the block into a graph.  A hybridized block (or one
with ``_active`` set) traces itself once per call structure and runs the
graph through a ``CachedOp``: the graph's ``GraphPlan``, run eagerly on the
tensors' device, the same ops with the same numbers as the eager path
(the JAX package compiles the graph with ``jax.jit`` instead; CUDA graphs
come later, ROADMAP item 4).  ``SymbolBlock`` wraps a ready-made Symbol.

Deferred initialization: a parameter whose shape has unknown (0)
dimensions is resolved by its own block from the first input it sees
(``_infer_param_shapes``), in the order the forward reaches the blocks;
on the graph path, by shape inference over the traced graph.
"""
from __future__ import annotations

import copy
import re
import threading
from typing import Dict, List

import torch

from ..base import np_dtype
from .. import autograd
from .. import ndarray as nd
from .. import symbol as sym_mod
from ..symbol import Symbol
from ..ndarray.register import write_back
from ..observability import introspect as _introspect
from ..symbol.graph import GraphPlan, infer_shapes_types
from .parameter import DeferredInitializationError, Parameter, ParameterDict


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


def _flatten(args, inout_str="input"):
    if isinstance(args, (torch.Tensor, Symbol)):
        return [args], int(0)
    if args is None:
        return [None], None
    if not isinstance(args, (list, tuple)):
        raise ValueError(f"{inout_str} must be (nested) list of Symbol or "
                         f"tensor, got {args}")
    flat = []
    fmts = []
    for i in args:
        arg, fmt = _flatten(i, inout_str)
        flat.extend(arg)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    if isinstance(fmt, int):
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    if fmt is None:
        return None, args[1:]
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


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

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's parameters; with ``select``, a
        regular expression, only those whose full name it matches (from the
        start, as ``re.match``)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children:
            ret.update(cld.collect_params(select))
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

    # upstream MXNet's later names for the same two calls
    save_parameters = save_params
    load_parameters = load_params

    def hybridize(self, active=True, **kwargs):
        for cld in self._children:
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args, **kwargs):
        """Runs the block with torch's grad mode equal to
        ``autograd.is_recording()``: outside ``record()`` (or under
        ``pause()``) no autograd graph is built, whatever requires
        gradients."""
        rec = autograd.is_recording()
        if torch.is_grad_enabled() == rec:
            return super().__call__(*args, **kwargs)
        with torch.set_grad_enabled(rec):
            return super().__call__(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError


class CachedOp:
    """A traced graph, ready to run (parity: Imperative::CachedOp,
    src/imperative/cached_op.cc).  The ``GraphPlan`` is built once; each
    call runs it eagerly on the tensors it is given, on their device, in
    train mode when ``autograd.is_training()``.  Under
    ``autograd.record()`` its ops record like any others, so the graph is
    differentiable as a whole (the JAX package takes the vjp of the jitted
    graph instead).  The aux tensors (BatchNorm's moving statistics) are
    read by the graph and, after a train-mode run, overwritten in place
    with their updated values, as ``mxnet_tpu/gluon/block.py`` does: the
    write is not recorded, and no recorded op saved them, so it passes
    torch's in-place check."""

    def __init__(self, symbol: Symbol):
        self.symbol = symbol
        self.plan = GraphPlan(symbol)
        self._noted = set()

    def __call__(self, arg_arrays: Dict[str, torch.Tensor],
                 aux_arrays: Dict[str, torch.Tensor] = None):
        aux_arrays = aux_arrays or {}
        train = autograd.is_training()
        if _introspect.ENABLED:
            self._count(arg_arrays, aux_arrays, train)
        outs, new_aux = self.plan.run(arg_arrays, aux_arrays,
                                      is_train=train)
        write_back((tgt, new_aux[name]) for name, tgt in aux_arrays.items())
        return outs

    def _count(self, arg_arrays, aux_arrays, train) -> None:
        """The introspector's ``gluon:fwd`` (and, under ``record()``,
        ``gluon:bwd``) programs, counted on meta copies at the first call
        of each signature."""
        rec = autograd.is_recording()
        sig = _introspect.plan_signature(arg_arrays, train, rec)
        if sig in self._noted:
            return
        self._noted.add(sig)
        grads = [k for k, v in arg_arrays.items()
                 if isinstance(v, torch.Tensor) and v.requires_grad] \
            if rec else []
        _introspect.count_plan(self.plan, arg_arrays, aux_arrays, train,
                               grads, "gluon:fwd",
                               "gluon:bwd" if grads else None, sig)


class HybridBlock(Block):
    """Parity: gluon/block.py HybridBlock."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._reg_params: Dict[str, Parameter] = {}
        self._active = False
        self._clear_cached_op()

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
        if isinstance(value, HybridBlock):
            self._clear_cached_op()
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but "
                f"{block} has type {type(block)}.")
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        """Run this block and its children through their traced graphs.
        MXNet's keyword flags (``static_alloc``, ``static_shape``) are
        accepted and have no effect."""
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        # call structure (repr of the input format) -> {"graph": (input
        # variables, output Symbol), "out_format", and once built "op"}
        self._cached_by_fmt = {}
        self._cached_op = None

    def _graph_entry(self, *args):
        """(cache entry, flat inputs) for the call structure of ``args``;
        the graph is traced on the structure's first call."""
        flat_args, in_format = _flatten(args)
        key = repr(in_format)
        entry = self._cached_by_fmt.get(key)
        if entry is None:
            entry = self._cached_by_fmt[key] = self._trace(flat_args,
                                                           in_format)
        return entry, flat_args

    def _trace(self, flat_args, in_format):
        inputs = [sym_mod.Variable(f"data{i}") if len(flat_args) > 1
                  else sym_mod.Variable("data")
                  for i in range(len(flat_args))]
        grouped, _ = _regroup(inputs, in_format)
        params = {name: p.var() for name, p in self._reg_params.items()}
        with self.name_scope():
            out = self.hybrid_forward(sym_mod, grouped, **params) \
                if not isinstance(grouped, list) else \
                self.hybrid_forward(sym_mod, *grouped, **params)
        flat_out, out_format = _flatten(out, "output")
        return {"graph": (inputs, sym_mod.Group(flat_out)),
                "out_format": out_format}

    def _get_graph(self, *args):
        """(input variables, output Symbol) of this block for the call
        structure of ``args``."""
        return self._graph_entry(*args)[0]["graph"]

    def infer_shape(self, *args):
        """Fix the shapes of this block's parameters from input tensors
        ``args`` by shape inference over its graph."""
        entry, flat_args = self._graph_entry(*args)
        inputs, out = entry["graph"]
        shapes = {i.name: a.shape for i, a in zip(inputs, flat_args)}
        types = {i.name: np_dtype(a.dtype) for i, a in zip(inputs, flat_args)}
        _, info, _ = infer_shapes_types(out, shapes, types, partial=False)
        all_params = {p.name: p for p in self.collect_params().values()}
        for name, struct in info.items():
            if name in all_params and struct is not None:
                all_params[name].shape = tuple(struct.shape)

    def _call_cached_op(self, *args):
        entry, flat_args = self._graph_entry(*args)
        if "op" not in entry:
            inputs, out = entry["graph"]
            params = {p.name: p for p in self.collect_params().values()}
            self._cached_op = CachedOp(out)
            entry["op"] = (self._cached_op, [i.name for i in inputs],
                           {n: params[n] for n in out.list_arguments()
                            if n in params},
                           {n: params[n] for n in out.list_auxiliary_states()
                            if n in params})
        op, input_names, params, aux_params = entry["op"]
        arg_dict = dict(zip(input_names, flat_args))
        for name, p in params.items():
            arg_dict[name] = p.data()
        aux_dict = {name: p.data() for name, p in aux_params.items()}
        ret, _ = _regroup(op(arg_dict, aux_dict), entry["out_format"])
        return ret

    def _run_graph(self, x, *args):
        """The cached op on tensors, resolving deferred parameter shapes by
        shape inference over the graph on the first call."""
        try:
            return self._call_cached_op(x, *args)
        except DeferredInitializationError:
            try:
                self.infer_shape(x, *args)
            except Exception as e:
                raise ValueError(
                    f"Deferred initialization failed because shape cannot "
                    f"be inferred: {e}")
            for p in self.collect_params().values():
                p._finish_deferred_init()
            return self._call_cached_op(x, *args)

    def _infer_param_shapes(self, x, *args):
        """Fix the unknown dimensions of this block's own parameters from
        its first input, by shape inference over its graph (the JAX
        package's ``_deferred_infer_shape``); Dense and LayerNorm read
        them off the input directly."""
        try:
            self.infer_shape(x, *args)
        except Exception as e:
            raise ValueError(
                f"Deferred initialization failed because shape cannot be "
                f"inferred: {e}") from e

    def forward(self, x, *args):
        if isinstance(x, Symbol):
            params = {name: p.var() for name, p in self._reg_params.items()}
            with self.name_scope():
                return self.hybrid_forward(sym_mod, x, *args, **params)
        if self._active:
            return self._run_graph(x, *args)
        if any(p.is_deferred for p in self._reg_params.values()):
            self._infer_param_shapes(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
        params = {name: p.data() for name, p in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """Wrap a Symbol as a Block (parity: gluon/block.py:542).  Its free
    variables other than ``inputs`` become parameters, named as in the
    graph, with shapes from the first input (deferred initialization).
    Called on tensors it runs the graph through a ``CachedOp``; called on
    a Symbol it composes the graph onto it."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol) and len(inputs) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        input_names = {i.name for i in inputs}
        for name in outputs.list_arguments():
            if name not in input_names:
                self.params.get(name, allow_deferred_init=True)._attach(
                    self, name)
        for name in outputs.list_auxiliary_states():
            if name not in input_names:
                self.params.get(name, grad_req="null",
                                allow_deferred_init=True)._attach(self, name)
        self._symbol_graph = (list(inputs), outputs)

    def _trace(self, flat_args, in_format):
        out = self._symbol_graph[1]
        return {"graph": self._symbol_graph,
                "out_format": 0 if len(out) == 1 else [0] * len(out)}

    def forward(self, x, *args):
        if isinstance(x, Symbol):
            inputs, out = self._symbol_graph
            ret = copy.copy(out)
            ret._compose(**{inputs[0].name: x})
            return ret
        return self._run_graph(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
