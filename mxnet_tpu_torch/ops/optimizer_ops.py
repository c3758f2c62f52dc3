"""Optimizer update operators: ``sgd_update``, ``sgd_mom_update``,
``mp_sgd_update``, ``mp_sgd_mom_update`` and ``adam_update``.

The counterpart of ``mxnet_tpu/ops/optimizer_ops.py:27-70``.  The JAX ops
return new values that its ``invoke`` writes back into the inputs they
declare mutated (the weight, ``mutates_input=0``) and into their states
(``aux_inputs``); the port's ``invoke`` has no notion of mutated inputs, so
each op here writes its weight and states in place itself, under
``torch.no_grad()`` (the weight may be a parameter that carries gradients),
and returns the weight.  The arithmetic is the JAX ops' expression by
expression.  The ``mp_`` variants step a float32 master copy of a
low-precision (bfloat16) weight and write its cast into the weight.
Not ported yet: ``rmsprop_update``, ``rmspropalex_update``,
``ftrl_update`` (ROADMAP.md, queue item 4, with their optimizers).
"""
from __future__ import annotations

import torch

from ..base import Arg
from .registry import register

_COMMON = [Arg("lr", float, required=True), Arg("wd", float, 0.0),
           Arg("rescale_grad", float, 1.0), Arg("clip_gradient", float, -1.0)]


def _prep_grad(p, grad, dtype=None):
    g = grad * p["rescale_grad"]
    if p["clip_gradient"] > 0:
        g = torch.clamp(g, -p["clip_gradient"], p["clip_gradient"])
    return g.to(dtype) if dtype is not None else g


@register("sgd_update", input_names=("weight", "grad"), args=list(_COMMON),
          differentiable=False)
def _sgd_update(p, weight, grad):
    with torch.no_grad():
        g = _prep_grad(p, grad, weight.dtype)
        weight.copy_(weight - p["lr"] * (g + p["wd"] * weight))
    return weight


@register("sgd_mom_update", input_names=("weight", "grad", "mom"),
          args=_COMMON + [Arg("momentum", float, 0.0)], differentiable=False)
def _sgd_mom_update(p, weight, grad, mom):
    with torch.no_grad():
        g = _prep_grad(p, grad, weight.dtype)
        new_mom = p["momentum"] * mom - p["lr"] * (g + p["wd"] * weight)
        weight.copy_(weight + new_mom)
        mom.copy_(new_mom)
    return weight


@register("mp_sgd_update", input_names=("weight", "grad", "weight32"),
          args=list(_COMMON), differentiable=False)
def _mp_sgd_update(p, weight, grad, weight32):
    """bf16/fp16 weights with a float32 master copy (parity:
    optimizer_op.cc:111)."""
    with torch.no_grad():
        g = _prep_grad(p, grad.float())
        weight32.copy_(weight32 - p["lr"] * (g + p["wd"] * weight32))
        weight.copy_(weight32)
    return weight


@register("mp_sgd_mom_update",
          input_names=("weight", "grad", "mom", "weight32"),
          args=_COMMON + [Arg("momentum", float, 0.0)], differentiable=False)
def _mp_sgd_mom_update(p, weight, grad, mom, weight32):
    with torch.no_grad():
        g = _prep_grad(p, grad.float())
        new_mom = p["momentum"] * mom - p["lr"] * (g + p["wd"] * weight32)
        mom.copy_(new_mom)
        weight32.add_(new_mom)
        weight.copy_(weight32)
    return weight


@register("adam_update", input_names=("weight", "grad", "mean", "var"),
          args=_COMMON + [Arg("beta1", float, 0.9), Arg("beta2", float, 0.999),
                          Arg("epsilon", float, 1e-8)],
          differentiable=False)
def _adam_update(p, weight, grad, mean, var):
    """``lr`` arrives bias-corrected (``optimizer.Adam`` folds the
    correction into it, as the reference does)."""
    with torch.no_grad():
        g = _prep_grad(p, grad, weight.dtype) + p["wd"] * weight
        mean.copy_(p["beta1"] * mean + (1 - p["beta1"]) * g)
        var.copy_(p["beta2"] * var + (1 - p["beta2"]) * torch.square(g))
        weight.copy_(weight - p["lr"] * mean / (torch.sqrt(var)
                                                + p["epsilon"]))
    return weight
