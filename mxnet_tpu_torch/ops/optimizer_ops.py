"""Optimizer update operators and the multi-tensor passes behind them.

The counterpart of ``mxnet_tpu/ops/optimizer_ops.py``: ``sgd_update``,
``sgd_mom_update``, ``mp_sgd_update``, ``mp_sgd_mom_update``,
``adam_update``, ``rmsprop_update``, ``rmspropalex_update`` and
``ftrl_update``.  The JAX ops return new values that its ``invoke`` writes
back into the inputs they declare mutated (the weight, ``mutates_input=0``)
and into their states (``aux_inputs``); the port's ``invoke`` has no notion
of mutated inputs, so each op here writes its weight and states in place
itself, under ``torch.no_grad()`` (the weight may be a parameter that
carries gradients), and returns the weight.

Each update is written once, as a pass over lists of tensors
(``multi_*``: ``torch._foreach_*`` ops, per-tensor learning rates and
weight decays as lists of Python floats, or as float64 tensors on the
weights' device, one value per weight, and ``rescale_grad`` as a 0-dim
float64 tensor: what a step captured into a CUDA graph reads, since a
Python float is frozen into the graph when it is captured).  The
registered ops call it on lists of one, and so do the optimizers'
per-parameter updates, while
``optimizer.FusedUpdater`` calls it on every parameter of one device and
dtype at once: the per-key and the fused step are the same arithmetic by
construction.  The lists of one pass must hold tensors of one device and
dtype, the grads' strides equal to their weights'.  The arithmetic is the
JAX ops' expression by expression.  The ``mp_`` variants step a float32
master copy of a low-precision (bfloat16) weight and write its cast into
the weight.
"""
from __future__ import annotations

import torch

from ..base import Arg
from .registry import register

_COMMON = [Arg("lr", float, required=True), Arg("wd", float, 0.0),
           Arg("rescale_grad", float, 1.0), Arg("clip_gradient", float, -1.0)]


def _seq(values):
    """Per-tensor hyper-parameters as a list: a 1-D tensor becomes its
    0-dim elements (views, so a captured step reads the values its cache
    writes in place)."""
    return list(values.unbind(0)) if isinstance(values, torch.Tensor) \
        else values


def prep_grads(grads, rescale_grad, clip_gradient, dtype=None):
    """``clip(grad * rescale_grad)``, cast to ``dtype``: new tensors (a
    gradient buffer is never written, so ``grad_req="add"`` keeps its
    sum)."""
    gs = torch._foreach_mul(list(grads), rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(gs, -clip_gradient)
        torch._foreach_clamp_max_(gs, clip_gradient)
    if dtype is not None and gs and gs[0].dtype != dtype:
        gs = [g.to(dtype) for g in gs]
    return gs


def _decayed(gs, weights, wds):
    """``g + wd * weight`` per tensor, into ``gs``."""
    torch._foreach_add_(gs, torch._foreach_mul(weights, wds))
    return gs


def _clip_weights(weights, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        torch._foreach_clamp_min_(weights, -clip_weights)
        torch._foreach_clamp_max_(weights, clip_weights)


@torch.no_grad()
def multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """``w -= lr * (g + wd * w)``."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = prep_grads(grads, rescale_grad, clip_gradient, weights[0].dtype)
    _decayed(gs, weights, wds)
    torch._foreach_mul_(gs, lrs)
    torch._foreach_sub_(weights, gs)


@torch.no_grad()
def multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """``mom = momentum * mom - lr * (g + wd * w)``; ``w += mom``."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = prep_grads(grads, rescale_grad, clip_gradient, weights[0].dtype)
    _decayed(gs, weights, wds)
    torch._foreach_mul_(gs, lrs)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_sub_(moms, gs)
    torch._foreach_add_(weights, moms)


@torch.no_grad()
def multi_nag_update(weights, grads, moms, lrs, wds, momentum=0.0,
                     rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov's lookahead (parity: optimizer.py NAG.fused_step):
    ``g = clip(grad * rescale) + wd * w``, ``mom = momentum * mom + g``,
    ``w -= lr * (g + momentum * mom)``; ``moms`` is None without
    momentum."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = _decayed(prep_grads(grads, rescale_grad, clip_gradient,
                             weights[0].dtype), weights, wds)
    if moms is not None:
        torch._foreach_mul_(moms, momentum)
        torch._foreach_add_(moms, gs)
        torch._foreach_add_(gs, torch._foreach_mul(moms, momentum))
    torch._foreach_mul_(gs, lrs)
    torch._foreach_sub_(weights, gs)


@torch.no_grad()
def multi_adam_update(weights, grads, means, variances, lrs, wds, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                      clip_gradient=-1.0):
    """``lrs`` arrive bias-corrected (``optimizer.Adam`` folds the
    correction into them, as the reference does)."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = _decayed(prep_grads(grads, rescale_grad, clip_gradient,
                             weights[0].dtype), weights, wds)
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, torch._foreach_mul(gs, 1 - beta1))
    torch._foreach_mul_(variances, beta2)
    torch._foreach_add_(variances,
                        torch._foreach_mul(torch._foreach_mul(gs, gs),
                                           1 - beta2))
    denom = torch._foreach_sqrt(variances)
    torch._foreach_add_(denom, epsilon)
    step = torch._foreach_mul(means, lrs)
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(weights, step)


@torch.no_grad()
def multi_rmsprop_update(weights, grads, ns, lrs, wds, gamma1=0.95,
                         epsilon=1e-8, clip_weights=-1.0, rescale_grad=1.0,
                         clip_gradient=-1.0):
    """``n = (1 - gamma1) * g^2 + gamma1 * n``;
    ``w -= lr * g / sqrt(n + eps)``, clipped to ``clip_weights``."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = _decayed(prep_grads(grads, rescale_grad, clip_gradient,
                             weights[0].dtype), weights, wds)
    sq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(sq, 1 - gamma1)
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_add_(ns, sq)
    denom = torch._foreach_add(ns, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_mul_(gs, lrs)
    torch._foreach_div_(gs, denom)
    torch._foreach_sub_(weights, gs)
    _clip_weights(weights, clip_weights)


@torch.no_grad()
def multi_rmspropalex_update(weights, grads, ns, gbars, deltas, lrs, wds,
                             gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                             clip_weights=-1.0, rescale_grad=1.0,
                             clip_gradient=-1.0):
    """Graves' centered RMSProp: ``n`` and ``gbar`` the running second and
    first moments, ``delta = gamma2 * delta - lr * g / sqrt(n - gbar^2 +
    eps)``, ``w += delta``."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = _decayed(prep_grads(grads, rescale_grad, clip_gradient,
                             weights[0].dtype), weights, wds)
    sq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(sq, 1 - gamma1)
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_add_(ns, sq)
    torch._foreach_mul_(gbars, gamma1)
    torch._foreach_add_(gbars, torch._foreach_mul(gs, 1 - gamma1))
    denom = torch._foreach_sub(ns, torch._foreach_mul(gbars, gbars))
    torch._foreach_add_(denom, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_mul_(gs, lrs)
    torch._foreach_div_(gs, denom)
    torch._foreach_mul_(deltas, gamma2)
    torch._foreach_sub_(deltas, gs)
    torch._foreach_add_(weights, deltas)
    _clip_weights(weights, clip_weights)


@torch.no_grad()
def multi_ftrl_update(weights, grads, zs, ns, lrs, wds, lamda1=0.01,
                      beta=1.0, rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal: ``z += g - (sqrt(n + g^2) - sqrt(n)) / lr * w``,
    ``n += g^2``, ``w = (sign(z) * lamda1 - z) / ((beta + sqrt(n)) / lr +
    wd)`` where ``|z| > lamda1``, else 0."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = prep_grads(grads, rescale_grad, clip_gradient, weights[0].dtype)
    old_sqrt = torch._foreach_sqrt(ns)
    torch._foreach_add_(ns, torch._foreach_mul(gs, gs))
    new_sqrt = torch._foreach_sqrt(ns)
    sigma = torch._foreach_sub(new_sqrt, old_sqrt)
    torch._foreach_div_(sigma, lrs)
    torch._foreach_add_(zs, gs)
    torch._foreach_sub_(zs, torch._foreach_mul(sigma, weights))
    denom = torch._foreach_add(new_sqrt, beta)
    torch._foreach_div_(denom, lrs)
    torch._foreach_add_(denom, wds)
    num = torch._foreach_sub(torch._foreach_mul(torch._foreach_sign(zs),
                                                lamda1), zs)
    torch._foreach_div_(num, denom)
    for w, z, v in zip(weights, zs, num):
        w.copy_(torch.where(z.abs() <= lamda1, torch.zeros_like(w), v))


@torch.no_grad()
def multi_adagrad_update(weights, grads, histories, lrs, wds, eps=1e-7,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """``hist += g^2``; ``w -= lr * (g / sqrt(hist + eps) + wd * w)``
    (parity: optimizer.py AdaGrad.fused_step)."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = prep_grads(grads, rescale_grad, clip_gradient)
    torch._foreach_add_(histories, torch._foreach_mul(gs, gs))
    denom = torch._foreach_add(histories, eps)
    torch._foreach_sqrt_(denom)
    torch._foreach_div_(gs, denom)
    _decayed(gs, weights, wds)
    torch._foreach_mul_(gs, lrs)
    torch._foreach_sub_(weights, gs)


@torch.no_grad()
def multi_adadelta_update(weights, grads, acc_gs, acc_deltas, wds, rho=0.9,
                          epsilon=1e-5, rescale_grad=1.0, clip_gradient=-1.0):
    """``acc_g = rho * acc_g + (1 - rho) * g^2``, ``d = sqrt(acc_delta +
    eps) / sqrt(acc_g + eps) * g``, ``acc_delta = rho * acc_delta + (1 -
    rho) * d^2``, ``w -= d + wd * w`` (parity: optimizer.py
    AdaDelta.fused_step; no learning rate)."""
    wds = _seq(wds)
    gs = prep_grads(grads, rescale_grad, clip_gradient)
    torch._foreach_mul_(acc_gs, rho)
    torch._foreach_add_(acc_gs, torch._foreach_mul(
        torch._foreach_mul(gs, gs), 1.0 - rho))
    num = torch._foreach_add(acc_deltas, epsilon)
    torch._foreach_sqrt_(num)
    den = torch._foreach_add(acc_gs, epsilon)
    torch._foreach_sqrt_(den)
    torch._foreach_div_(num, den)
    torch._foreach_mul_(num, gs)
    torch._foreach_mul_(acc_deltas, rho)
    torch._foreach_add_(acc_deltas, torch._foreach_mul(
        torch._foreach_mul(num, num), 1.0 - rho))
    decay = torch._foreach_mul(weights, wds)
    torch._foreach_sub_(weights, num)
    torch._foreach_sub_(weights, decay)


@torch.no_grad()
def multi_adamax_update(weights, grads, ms, us, lrs, wds, beta1=0.9,
                        beta2=0.999, rescale_grad=1.0, clip_gradient=-1.0):
    """``g = clip(grad * rescale + wd * w)``, ``m = beta1 * m + (1 - beta1)
    * g``, ``u = max(beta2 * u, |g|)``, ``w -= lr * m / u``; ``lrs`` arrive
    divided by ``1 - beta1^t`` (parity: optimizer.py Adamax.fused_step)."""
    lrs, wds = _seq(lrs), _seq(wds)
    gs = _decayed(torch._foreach_mul(list(grads), rescale_grad), weights,
                  wds)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(gs, -clip_gradient)
        torch._foreach_clamp_max_(gs, clip_gradient)
    torch._foreach_mul_(ms, beta1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - beta1))
    torch._foreach_mul_(us, beta2)
    torch._foreach_maximum_(us, torch._foreach_abs(gs))
    step = torch._foreach_mul(ms, lrs)
    torch._foreach_div_(step, us)
    torch._foreach_sub_(weights, step)


# -- the registered ops: the passes above on lists of one --------------------
def _common(p):
    return dict(rescale_grad=p["rescale_grad"],
                clip_gradient=p["clip_gradient"])


@register("sgd_update", input_names=("weight", "grad"), args=list(_COMMON),
          differentiable=False)
def _sgd_update(p, weight, grad):
    multi_sgd_update([weight], [grad], [p["lr"]], [p["wd"]], **_common(p))
    return weight


@register("sgd_mom_update", input_names=("weight", "grad", "mom"),
          args=_COMMON + [Arg("momentum", float, 0.0)], differentiable=False)
def _sgd_mom_update(p, weight, grad, mom):
    multi_sgd_mom_update([weight], [grad], [mom], [p["lr"]], [p["wd"]],
                         momentum=p["momentum"], **_common(p))
    return weight


@register("mp_sgd_update", input_names=("weight", "grad", "weight32"),
          args=list(_COMMON), differentiable=False)
def _mp_sgd_update(p, weight, grad, weight32):
    """bf16/fp16 weights with a float32 master copy (parity:
    optimizer_op.cc:111)."""
    multi_sgd_update([weight32], [grad.float()], [p["lr"]], [p["wd"]],
                     **_common(p))
    with torch.no_grad():
        weight.copy_(weight32)
    return weight


@register("mp_sgd_mom_update",
          input_names=("weight", "grad", "mom", "weight32"),
          args=_COMMON + [Arg("momentum", float, 0.0)], differentiable=False)
def _mp_sgd_mom_update(p, weight, grad, mom, weight32):
    multi_sgd_mom_update([weight32], [grad.float()], [mom], [p["lr"]],
                         [p["wd"]], momentum=p["momentum"], **_common(p))
    with torch.no_grad():
        weight.copy_(weight32)
    return weight


@register("adam_update", input_names=("weight", "grad", "mean", "var"),
          args=_COMMON + [Arg("beta1", float, 0.9), Arg("beta2", float, 0.999),
                          Arg("epsilon", float, 1e-8)],
          differentiable=False)
def _adam_update(p, weight, grad, mean, var):
    """``lr`` arrives bias-corrected."""
    multi_adam_update([weight], [grad], [mean], [var], [p["lr"]], [p["wd"]],
                      beta1=p["beta1"], beta2=p["beta2"],
                      epsilon=p["epsilon"], **_common(p))
    return weight


@register("rmsprop_update", input_names=("weight", "grad", "n"),
          args=_COMMON + [Arg("gamma1", float, 0.95),
                          Arg("epsilon", float, 1e-8),
                          Arg("clip_weights", float, -1.0)],
          differentiable=False)
def _rmsprop_update(p, weight, grad, n):
    multi_rmsprop_update([weight], [grad], [n], [p["lr"]], [p["wd"]],
                         gamma1=p["gamma1"], epsilon=p["epsilon"],
                         clip_weights=p["clip_weights"], **_common(p))
    return weight


@register("rmspropalex_update",
          input_names=("weight", "grad", "n", "g", "delta"),
          args=_COMMON + [Arg("gamma1", float, 0.95),
                          Arg("gamma2", float, 0.9),
                          Arg("epsilon", float, 1e-8),
                          Arg("clip_weights", float, -1.0)],
          differentiable=False)
def _rmspropalex_update(p, weight, grad, n, gbar, delta):
    multi_rmspropalex_update([weight], [grad], [n], [gbar], [delta],
                             [p["lr"]], [p["wd"]], gamma1=p["gamma1"],
                             gamma2=p["gamma2"], epsilon=p["epsilon"],
                             clip_weights=p["clip_weights"], **_common(p))
    return weight


@register("ftrl_update", input_names=("weight", "grad", "z", "n"),
          args=_COMMON + [Arg("lamda1", float, 0.01), Arg("beta", float, 1.0)],
          differentiable=False)
def _ftrl_update(p, weight, grad, z, n):
    multi_ftrl_update([weight], [grad], [z], [n], [p["lr"]], [p["wd"]],
                      lamda1=p["lamda1"], beta=p["beta"], **_common(p))
    return weight
