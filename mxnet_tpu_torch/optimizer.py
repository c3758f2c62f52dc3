"""Optimizers and the Updater (parity: python/mxnet/optimizer.py).

The counterpart of ``mxnet_tpu/optimizer.py``: ``Optimizer`` (learning
rate and its scheduler, weight decay, ``rescale_grad``, ``clip_gradient``,
per-parameter ``lr_mult`` / ``wd_mult``, per-index update counts,
``multi_precision`` with float32 master weights for bfloat16 and float16
weights, the multipliers a Module's graph carries, ``sym=``), ``SGD`` and
``Adam``, which step through the update ops of
``ops/optimizer_ops.py`` in place, one parameter at a time, and the
per-parameter ``Updater``.

``get_updater`` returns that ``Updater``: it computes the same update as
the JAX package's default ``FusedUpdater`` (which traces every parameter's
step into one program; its ``MXNET_FUSED_TRAINER=0`` path is this one).
``FusedUpdater``, the other optimizers and the pickled updater states are
not ported yet (ROADMAP.md, queue item 4).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from . import ndarray as nd
from .base import MXNetError, Registry

_REG = Registry("optimizer")
_STATES_ITEM = ("updater states are pickled with the checkpoint module, "
                "which is not ported yet (ROADMAP.md, queue item 4: the "
                "fused step and checkpoints)")


def _is_low_prec(dtype) -> bool:
    """float16/bfloat16 weights get float32 master copies under
    multi_precision (parity: optimizer_op.cc mp_sgd_*)."""
    return dtype in (torch.float16, torch.bfloat16)


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        # the graph's __lr_mult__/__wd_mult__ attributes (a Module's symbol)
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ({}, [])
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- registry -----------------------------------------------------------
    @staticmethod
    def register(klass):
        _REG.register(klass)
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        return _REG.get(name)(**kwargs)

    # -- state --------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _is_low_prec(weight.dtype):
            w32 = weight.detach().float()
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_low_prec(weight.dtype):
            inner, w32 = state
            self.update(index, w32, grad.float(), inner)
            with torch.no_grad():
                weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    # -- lr/wd plumbing ------------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set lr directly")
        self.lr = lr

    def _sym_mults(self, key):
        attr, arg_names = self.sym_info
        return {n: float(attr[n][key]) for n in arg_names
                if key in attr.get(n, {})}

    def set_lr_mult(self, args_lr_mult):
        """Per-parameter lr multipliers: the graph's ``__lr_mult__``, then
        ``args_lr_mult``."""
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-parameter wd multipliers: 0 for a name that ends in neither
        ``_weight`` nor ``_gamma``, then the graph's ``__wd_mult__``, then
        ``args_wd_mult``."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index) -> float:
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common_kwargs(self):
        kw = dict(rescale_grad=self.rescale_grad)
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum and multi-precision (parity: optimizer.py:435)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.multi_precision and _is_low_prec(weight.dtype):
            return self.create_state_multi_precision(index, weight)
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def _update_impl(self, index, weight, grad, state, multi_precision):
        """One count bump and one update op (update and
        update_multi_precision share it, so num_update advances once per
        step)."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = self._common_kwargs()
        if multi_precision:
            inner, w32 = state
            if self.momentum != 0.0:
                nd.mp_sgd_mom_update(weight, grad, inner, w32, lr=lr, wd=wd,
                                     momentum=self.momentum, **kw)
            else:
                nd.mp_sgd_update(weight, grad, w32, lr=lr, wd=wd, **kw)
        elif state is not None:
            nd.sgd_mom_update(weight, grad, state, lr=lr, wd=wd,
                              momentum=self.momentum, **kw)
        else:
            nd.sgd_update(weight, grad, lr=lr, wd=wd, **kw)

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, False)

    def update_multi_precision(self, index, weight, grad, state):
        use_mp = self.multi_precision and _is_low_prec(weight.dtype)
        self._update_impl(index, weight, grad, state, use_mp)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate
    (parity: optimizer.py Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)
        mean, var = state
        nd.adam_update(weight, grad, mean, var, lr=lr, wd=self._get_wd(index),
                       beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, **self._common_kwargs())


class Updater:
    """Applies an optimizer with per-index states (parity:
    optimizer.get_updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        raise NotImplementedError(f"Updater.set_states: {_STATES_ITEM}")

    def get_states(self, dump_optimizer=False):
        raise NotImplementedError(f"Updater.get_states: {_STATES_ITEM}")


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
