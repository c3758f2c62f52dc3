"""Reductions and ordering ops: ``argmax``, ``topk``, ``sort``, ``argsort``.

The counterpart of part of ``mxnet_tpu/ops/reduce.py``.  Indices come back
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


@register("argmax", input_names=("data",),
          args=[Arg("axis", int, None), Arg("keepdims", bool, False)],
          differentiable=False)
def _argmax(p, x):
    if p["axis"] is None:
        return torch.argmax(x.reshape(-1), dim=0).to(x.dtype)
    out = torch.argmax(x, dim=p["axis"], keepdim=p["keepdims"])
    return out.to(torch.float32)


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
    out = torch.sort(x, dim=p["axis"]).values
    return out if p["is_ascend"] else torch.flip(out, dims=(p["axis"],))


@register("argsort", input_names=("data",),
          args=[Arg("axis", int, -1), Arg("is_ascend", bool, True),
                Arg("dtype", str, "float32")],
          differentiable=False)
def _argsort(p, x):
    key = x if p["is_ascend"] else -x
    return torch.sort(key, dim=p["axis"], stable=True).indices.to(
        torch.float32)
