"""Eager op invocation and the generated ``nd.*`` functions.

The counterpart of ``mxnet_tpu/ndarray/register.py``: one function per
registered op (and alias), with the JAX wrapper's signature
``fn(*args, out=None, **kwargs)``.  Positional tensors (numpy arrays and
lists too, converted on the current context) are the op's inputs, any
positional values after them fill the schema's arguments in declared
order; a tensor passed by an input's name takes that input's slot (slots
skipped before it are ``None``); other keywords are normalized by the
op's ``Arg`` schema, and ``name=`` is accepted and dropped.  Ops run
eagerly on ``torch.Tensor``s; an op with several outputs returns a list,
and ``out=`` (a tensor or a list) is written with the results and
returned.  An op with aux states writes their updated values back into
the tensors passed for them.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..autograd import is_recording, is_training
from ..ops import registry as _reg


def invoke(op_name: str, inputs, kwargs, out=None):
    """Execute a registered op eagerly on tensors.  Under ``record()`` the
    outputs of an op registered with ``differentiable=False`` are detached:
    the JAX package records only differentiable ops
    (``mxnet_tpu/ndarray/register.py:92``), so no gradient flows through
    them."""
    op = _reg.get_op(op_name)
    kwargs = dict(kwargs)
    kwargs.pop("name", None)
    arg_names = op.schema.args
    if "num_args" not in arg_names:
        kwargs.pop("num_args", None)
    elif op.variadic:
        kwargs.setdefault("num_args", len(inputs))
    params = dict(op.normalize(kwargs))
    if op.takes_is_train:
        params["__is_train__"] = is_training()
    outs = _reg.apply_op(op, params, inputs)
    n_vis = len(outs) - len(op.aux_inputs)
    write_back((inputs[i], new) for i, new in zip(op.aux_inputs, outs[n_vis:])
               if i < len(inputs) and inputs[i] is not None)
    outs = outs[:n_vis]
    if not op.differentiable and is_recording():
        outs = tuple(o.detach() for o in outs)
    if out is not None:
        targets = list(out) if isinstance(out, (list, tuple)) else [out]
        with torch.set_grad_enabled(is_recording()):
            for tgt, res in zip(targets, outs):
                tgt.copy_(res.to(tgt.dtype))
        outs = tuple(targets)
    return outs[0] if len(outs) == 1 else list(outs)


def write_back(pairs) -> None:
    """Copy each updated aux value (BatchNorm's moving statistics) into its
    target tensor, as the JAX package writes them back
    (``mxnet_tpu/ndarray/register.py``).  ``pairs`` yields (target, new
    value).  The write is not recorded: it runs under ``no_grad`` and skips
    a value the op returned unchanged, so a tensor that a recorded op saved
    for its backward is never written."""
    with torch.no_grad():
        for tgt, new in pairs:
            if new is not tgt:
                tgt.copy_(new)


_ARRAY_LIKE = (torch.Tensor, _np.ndarray, list, tuple)


def _as_input(a):
    """A tensor for an input given as a tensor, numpy array or list (on the
    current context, as ``nd.array`` places it)."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    from .ndarray import array
    return array(a)


def _make_nd_func(op_name: str):
    op = _reg.get_op(op_name)

    def fn(*args, out=None, **kwargs):
        inputs = []
        rest = list(args)
        # positional tensors are inputs; positional scalars map onto params
        while rest and isinstance(rest[0], _ARRAY_LIKE) and (
                op.variadic or len(inputs) < len(op.input_names)):
            inputs.append(_as_input(rest.pop(0)))
        taken = [n for n in op.schema.args if n not in kwargs]
        for v, n in zip(rest, taken):
            kwargs[n] = v
        # tensors passed by an input's name take its slot
        if not op.variadic:
            for i, n in enumerate(op.input_names):
                if n in kwargs and (kwargs[n] is None or
                                    isinstance(kwargs[n], _ARRAY_LIKE)):
                    v = _as_input(kwargs.pop(n))
                    inputs.extend([None] * (i + 1 - len(inputs)))
                    inputs[i] = v
        return invoke(op_name, inputs, kwargs, out=out)

    fn.__name__ = op_name
    fn.__qualname__ = op_name
    fn.__doc__ = op.docstring or f"Autogenerated wrapper for operator '{op_name}'."
    return fn


def populate(namespace: dict) -> None:
    """Generate one function per op into ``namespace``."""
    for name in list(_reg.OP_REGISTRY) + list(_reg.OP_ALIASES):
        namespace[name] = _make_nd_func(name)
