"""Reductions of the serving slice: ``argmax`` with ``keepdims``.

The counterpart of part of ``mxnet_tpu/ops/reduce.py``.  Indices come back
as float32, as in MXNet; with no axis the flat index keeps the input dtype.
Ties resolve to the first index, as ``jnp.argmax`` does.
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
