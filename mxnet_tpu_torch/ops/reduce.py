"""Reductions and ordering ops: ``sum``, ``mean``, ``prod``, ``max``,
``min``, ``nansum``, ``nanprod``, ``norm``, ``argmax``, ``argmin``,
``argmax_channel``, ``topk``, ``sort``, ``argsort``.

The counterpart of part of ``mxnet_tpu/ops/reduce.py``.  The reductions
take MXNet's ``axis`` (an int or a tuple; none means all), ``keepdims`` and
``exclude`` (reduce over every axis but those), and each has its
``<name>_axis`` alias.  An empty set of axes reduces nothing, as
``jnp.sum(x, axis=())`` does (``torch.sum(x, dim=())`` would reduce all
of them).  Indices come back
as float32, as in MXNet; with no axis the flat index keeps the input dtype.
Ties resolve to the first index, as ``jnp.argmax`` does.  ``topk`` and
``argsort`` take their indices from a stable sort (of ``-x`` when
descending), as the JAX package does: ``torch.topk`` promises no order
among equal values, and beam search must pick the same beams under ties.
"""
from __future__ import annotations

import torch

from ..base import Arg
from .registry import register

_REDUCE_ARGS = [Arg("axis", "shape", None), Arg("keepdims", bool, False),
                Arg("exclude", bool, False)]


def _norm_axis(p, ndim):
    axis = p.get("axis")
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    else:
        axes = tuple(a % ndim for a in axis)
    if p.get("exclude"):
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):   # later axes first: no index shift
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


def _inexact(x):
    """x, integers as float32: the JAX package's mean of an int32 or uint8
    array is float32."""
    return x if x.is_floating_point() else x.float()


def _mean(x, dim, keepdim):
    return torch.mean(_inexact(x), dim=dim, keepdim=keepdim)


_REDUCERS = {
    "sum": (torch.sum, lambda x: x),
    "mean": (_mean, _inexact),
    "prod": (_prod, lambda x: x),
    "max": (torch.amax, lambda x: x),
    "min": (torch.amin, lambda x: x),
    "nansum": (torch.nansum, lambda x: torch.nan_to_num(x, nan=0.0)),
    "nanprod": (_nanprod,
                lambda x: torch.where(torch.isnan(x), torch.ones_like(x), x)),
}


def _reduce(fn, over_nothing):
    def run(p, x):
        axes = _norm_axis(p, x.dim())
        if not axes:
            return over_nothing(x)
        return fn(x, dim=axes, keepdim=bool(p.get("keepdims")))
    return run


for _name, (_fn, _none) in _REDUCERS.items():
    register(_name, input_names=("data",), args=list(_REDUCE_ARGS),
             aliases=(_name + "_axis",))(_reduce(_fn, _none))


@register("norm", input_names=("data",),
          args=[Arg("ord", int, 2), Arg("axis", "shape", None),
                Arg("keepdims", bool, False)])
def _norm(p, x):
    """The L1 norm (``ord=1``), else sqrt(sum(x^2)) over ``axis`` (all axes
    when none), as the JAX package writes it: its gradient at 0 is NaN,
    where ``torch.linalg.norm``'s is 0."""
    axes = tuple(a % x.dim() for a in p["axis"]) if p["axis"] \
        else tuple(range(x.dim()))
    if p["ord"] == 1:
        return torch.sum(torch.abs(x), dim=axes, keepdim=p["keepdims"])
    return torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                keepdim=p["keepdims"]))


def _arg_reduce(fn):
    """Indices as float32 along ``axis``; with no axis the flat index in
    the input's dtype, as the JAX package gives."""
    def run(p, x):
        if p["axis"] is None:
            return fn(x.reshape(-1), dim=0).to(x.dtype)
        return fn(x, dim=p["axis"], keepdim=p["keepdims"]).to(torch.float32)
    return run


for _name, _fn in (("argmax", torch.argmax), ("argmin", torch.argmin)):
    register(_name, input_names=("data",),
             args=[Arg("axis", int, None), Arg("keepdims", bool, False)],
             differentiable=False)(_arg_reduce(_fn))


@register("argmax_channel", input_names=("data",), differentiable=False)
def _argmax_channel(p, x):
    return torch.argmax(x, dim=-1).to(torch.float32)


@register("topk", input_names=("data",),
          args=[Arg("axis", int, -1), Arg("k", int, 1), Arg("ret_typ", str, "indices"),
                Arg("is_ascend", bool, False), Arg("dtype", str, "float32")],
          differentiable=False)
def _topk(p, x):
    """Parity: src/operator/tensor/ordering_op.cc TopK.  ``ret_typ``
    'indices' gives float32 indices; every other value gives the values,
    as the JAX package does ('both' and 'mask' included, where upstream
    MXNet returns [values, indices] and a 0/1 mask)."""
    axis = p["axis"] % x.dim()
    xm = torch.movedim(x, axis, -1)
    key = xm if p["is_ascend"] else -xm
    idx = torch.sort(key, dim=-1, stable=True).indices[..., :p["k"]]
    if p["ret_typ"] == "indices":
        return torch.movedim(idx, -1, axis).to(torch.float32)
    return torch.movedim(torch.gather(xm, -1, idx), -1, axis)


@register("sort", input_names=("data",),
          args=[Arg("axis", int, -1), Arg("is_ascend", bool, True)])
def _sort(p, x):
    """``axis=None`` sorts the flattened input, as ``jnp.sort`` does."""
    axis = p["axis"]
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = torch.sort(x, dim=axis).values
    return out if p["is_ascend"] else torch.flip(out, dims=(axis,))


@register("argsort", input_names=("data",),
          args=[Arg("axis", int, -1), Arg("is_ascend", bool, True),
                Arg("dtype", str, "float32")],
          differentiable=False)
def _argsort(p, x):
    """``axis=None`` gives indices into the flattened input."""
    axis = p["axis"]
    if axis is None:
        x, axis = x.reshape(-1), 0
    key = x if p["is_ascend"] else -x
    return torch.sort(key, dim=axis, stable=True).indices.to(torch.float32)
