"""Creation operators (parity: ``mxnet_tpu/ops/init_ops.py``): ``_zeros``,
``_ones``, ``_full``, ``_arange`` and ``_eye``, the ops behind
``sym.zeros`` / ``ones`` / ``full`` / ``arange`` / ``eye``.

They take no input tensor, so their ``ctx`` argument says where the result
lies: a context name as graph files carry it (``"gpu(0)"``, ``"cpu(0)"``),
a torch device name, or none for the current context.  A Symbol graph run
by ``GraphPlan`` fills an unset ``ctx`` with the device it runs on.
"""
from __future__ import annotations

import re

import torch

from ..base import Arg, torch_dtype
from ..context import Context, as_device
from .registry import register

_CREATE_ARGS = [Arg("shape", "shape", ()), Arg("dtype", str, "float32"),
                Arg("ctx", str, None)]


def device_of(ctx):
    m = re.fullmatch(r"(cpu|gpu)\((\d+)\)", ctx or "")
    if m:
        return Context(m.group(1), int(m.group(2))).torch_device()
    return as_device(ctx)


@register("_zeros", input_names=(), args=list(_CREATE_ARGS),
          differentiable=False)
def _zeros(p):
    return torch.zeros(p["shape"], dtype=torch_dtype(p["dtype"]),
                       device=device_of(p["ctx"]))


@register("_ones", input_names=(), args=list(_CREATE_ARGS),
          differentiable=False)
def _ones(p):
    return torch.ones(p["shape"], dtype=torch_dtype(p["dtype"]),
                      device=device_of(p["ctx"]))


@register("_full", input_names=(),
          args=_CREATE_ARGS + [Arg("value", float, required=True)],
          differentiable=False)
def _full(p):
    return torch.full(p["shape"], p["value"], dtype=torch_dtype(p["dtype"]),
                      device=device_of(p["ctx"]))


@register("_arange", input_names=(),
          args=[Arg("start", float, 0.0), Arg("stop", float, None),
                Arg("step", float, 1.0), Arg("repeat", int, 1),
                Arg("dtype", str, "float32"), Arg("ctx", str, None),
                Arg("infer_range", bool, False)],
          differentiable=False)
def _arange(p):
    start, stop = p["start"], p["stop"]
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, p["step"], dtype=torch_dtype(p["dtype"]),
                       device=device_of(p["ctx"]))
    if p["repeat"] > 1:
        out = torch.repeat_interleave(out, p["repeat"])
    return out


@register("_eye", input_names=(),
          args=[Arg("N", int, required=True), Arg("M", int, 0), Arg("k", int, 0),
                Arg("dtype", str, "float32"), Arg("ctx", str, None)],
          differentiable=False)
def _eye(p):
    """An N x M (M 0: N x N) matrix with ones on diagonal ``k``."""
    out = torch.zeros((p["N"], p["M"] or p["N"]),
                      dtype=torch_dtype(p["dtype"]), device=device_of(p["ctx"]))
    out.diagonal(p["k"]).fill_(1)
    return out
