"""Optimizers, the Updater and the FusedUpdater (parity:
python/mxnet/optimizer.py).

The counterpart of ``mxnet_tpu/optimizer.py``: ``Optimizer`` (learning
rate and its scheduler, weight decay, ``rescale_grad``, ``clip_gradient``,
per-parameter ``lr_mult`` / ``wd_mult``, per-index update counts,
``multi_precision`` with float32 master weights for bfloat16 and float16
weights, the multipliers a Module's graph carries, ``sym=``) and its 13
registered optimizers under the JAX names: ``SGD``, ``ccSGD``, ``NAG``,
``Adam``, ``RMSProp`` (``centered``), ``AdaGrad``, ``AdaDelta``, ``Ftrl``,
``Adamax``, ``Nadam``, ``SGLD``, ``DCASGD`` and ``Test``.

The eight that the JAX package fuses (``fused = True``: SGD, NAG, Adam,
RMSProp, AdaGrad, AdaDelta, Ftrl, Adamax) step through the multi-tensor
passes of ``ops/optimizer_ops.py`` (``torch._foreach_*``): ``fused_step``
takes the parameters of one device and dtype at once, and a per-parameter
``update`` is ``fused_step`` on a list of one, so the two paths are the
same arithmetic.  Under ``multi_precision`` a bfloat16 or float16 weight
steps its float32 master and takes its cast (the in-place ops keep every
weight and state in its own dtype, which the JAX package's ``cast_like``
restores).  Nadam, SGLD, DCASGD and Test update one parameter at a time,
as in the JAX package.

``get_updater`` returns a ``FusedUpdater``: ``update_all(indices, grads,
weights)`` advances every index's count, then makes one ``fused_step`` per
(device, dtype, multi-precision) group; an optimizer that is not fused
takes the per-key loop.

A step captured into a CUDA graph (``gluon.wholestep``, ``Module``'s
``MXNET_FUSED_STEP``) passes ``fused_step`` its hyper-parameters as device
tensors (``hyper=``): the learning rates and weight decays as float64
vectors and ``rescale_grad`` as a float64 scalar, which
``HyperDeviceCache`` writes in place only when a schedule moves them, and
the applied-step counter ``t`` as an int64 vector that the step itself
advances.  Adam's and Adamax's bias corrections are then computed on the
device in float64 from that counter, the expression the eager step
computes on the host, so the two give the same learning rates (CUDA's
float64 ``pow`` may differ from the host's in the last bit, which the
cast to float32 almost always absorbs).

``Updater.get_states`` / ``set_states`` pickle the states (and with
``dump_optimizer`` the optimizer) in the JAX package's format
(``ndarray.dumps`` / ``ndarray.loads``); loaded states move onto their
weight's device when it is first updated.
"""
from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Any, Dict, NamedTuple

import torch

from . import random as _random
from .base import MXNetError, Registry
from .faultinject import fire as _fi_fire
from .ndarray import ndarray as _nd
from .observability import introspect as _introspect
from .observability import memory as _memory
from .observability import metrics as _metrics
from .observability.tracing import trace_span
from .ops import optimizer_ops as _ops

_REG = Registry("optimizer")


class DeviceHypers(NamedTuple):
    """A captured step's hyper-parameters on the device: float64 ``lr`` and
    ``wd`` and int64 ``t``, one value per index, and the float64 scalar
    ``rescale``."""
    lr: torch.Tensor
    wd: torch.Tensor
    t: torch.Tensor
    rescale: torch.Tensor

    def select(self, positions):
        """The values at ``positions``, an index tensor on the device made
        before any capture (all of them when None)."""
        if positions is None:
            return self
        return DeviceHypers(self.lr.index_select(0, positions),
                            self.wd.index_select(0, positions),
                            self.t.index_select(0, positions), self.rescale)


def _pow_each(base: float, ts: torch.Tensor) -> torch.Tensor:
    """``base ** t`` for each element of the float64 vector ``ts``.  On the
    CPU one 0-dim ``pow`` per element: that is libm's, as Python's ``**``
    is, where the vectorized CPU kernel rounds some values differently in
    the last bit.  On a card, one kernel."""
    if ts.device.type == "cpu":
        return torch.stack([torch.pow(base, t) for t in ts.unbind(0)]) \
            if ts.numel() else ts.clone()
    return torch.pow(base, ts)


def _is_low_prec(dtype) -> bool:
    """float16/bfloat16 weights get float32 master copies under
    multi_precision (parity: optimizer_op.cc mp_sgd_*)."""
    return dtype in (torch.float16, torch.bfloat16)


class Optimizer:
    #: True when the optimizer steps lists of parameters (``fused_step``)
    fused = False
    #: the hyper-parameters, besides ``clip_gradient`` and
    #: ``multi_precision``, that a captured step bakes in
    _hyper_attrs = ()

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

    # -- the step -----------------------------------------------------------
    def update(self, index, weight, grad, state):
        """One parameter's step; a fused optimizer runs ``fused_step`` on
        a list of one."""
        if not self.fused:
            raise NotImplementedError
        self._update_count(index)
        self.fused_step([index], [weight], [grad], [state], False)

    def update_multi_precision(self, index, weight, grad, state):
        use_mp = self.multi_precision and _is_low_prec(weight.dtype)
        if self.fused:
            self._update_count(index)
            self.fused_step([index], [weight], [grad], [state], use_mp)
        elif use_mp:
            inner, w32 = state
            self.update(index, w32, grad.float(), inner)
            with torch.no_grad():
                weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    def fused_hyper_key(self):
        """The hyper-parameters a captured step bakes in: a step captured
        under other values is captured again (``rescale_grad``, the
        learning rates and weight decays ride device tensors)."""
        return (type(self).__name__, self.clip_gradient,
                self.multi_precision) + tuple(getattr(self, a)
                                              for a in self._hyper_attrs)

    def fused_step(self, indices, weights, grads, states, multi_precision,
                   hyper: DeviceHypers = None):
        """Step the parameters ``indices`` (one device, one dtype) whose
        counts have advanced: low-precision weights under
        ``multi_precision`` step their float32 masters and take their
        casts.  ``hyper`` gives the hyper-parameters as device tensors;
        without it they are read on the host."""
        if hyper is None:
            lrs = [self._get_lr(i) for i in indices]
            wds = [self._get_wd(i) for i in indices]
            ts = [self._index_update_count[i] for i in indices]
        else:
            lrs, wds, ts = hyper.lr, hyper.wd, hyper.t
            self._dev_rescale = hyper.rescale
        try:
            if multi_precision:
                inner = [s[0] for s in states]
                masters = [s[1] for s in states]
                self._multi_update(masters,
                                   _like(grads, masters, torch.float32),
                                   inner, lrs, wds, ts)
                with torch.no_grad():
                    torch._foreach_copy_(weights, masters)
            else:
                self._multi_update(weights, _like(grads, weights), states,
                                   lrs, wds, ts)
        finally:
            self._dev_rescale = None

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        raise NotImplementedError

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
        dev = getattr(self, "_dev_rescale", None)
        return dict(rescale_grad=self.rescale_grad if dev is None else dev,
                    clip_gradient=-1.0 if self.clip_gradient is None
                    else self.clip_gradient)

    def _prepped(self, grad):
        """``clip(grad * rescale_grad)`` for the per-key optimizers."""
        return _ops.prep_grads([grad], **self._common_kwargs())[0]


def _like(grads, weights, dtype=None):
    """The gradients in ``dtype`` with their weights' strides, so a list
    and its lists of one take the same ``_foreach`` route."""
    out = []
    for g, w in zip(grads, weights):
        if dtype is not None and g.dtype != dtype:
            g = g.to(dtype)
        if g.stride() != w.stride():
            g = torch.empty_like(w, dtype=g.dtype).copy_(g)
        out.append(g)
    return out


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum and multi-precision (parity: optimizer.py:245)."""

    fused = True
    _hyper_attrs = ("momentum",)

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.multi_precision and _is_low_prec(weight.dtype):
            return self.create_state_multi_precision(index, weight)
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        if self.momentum == 0.0:
            _ops.multi_sgd_update(weights, grads, lrs, wds,
                                  **self._common_kwargs())
        else:
            _ops.multi_sgd_mom_update(weights, grads, states, lrs, wds,
                                      momentum=self.momentum,
                                      **self._common_kwargs())


@register
class ccSGD(SGD):
    """Deprecated alias of SGD (parity: optimizer.py:347)."""


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (parity: optimizer.py:352, the lookahead
    form: w -= lr * (grad + momentum * mom) after mom = momentum * mom +
    grad)."""

    fused = True
    _hyper_attrs = ("momentum",)

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else torch.zeros_like(weight)

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        _ops.multi_nag_update(weights, grads,
                              None if self.momentum == 0.0 else states,
                              lrs, wds, momentum=self.momentum,
                              **self._common_kwargs())


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate
    (parity: optimizer.py:428)."""

    fused = True
    _hyper_attrs = ("beta1", "beta2", "epsilon")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        if isinstance(ts, torch.Tensor):
            t = ts.double()
            lrs = lrs * torch.sqrt(1.0 - _pow_each(self.beta2, t)) \
                / (1.0 - _pow_each(self.beta1, t))
        else:
            lrs = [lr * math.sqrt(1.0 - self.beta2 ** t)
                   / (1.0 - self.beta1 ** t) for lr, t in zip(lrs, ts)]
        _ops.multi_adam_update(weights, grads, [s[0] for s in states],
                               [s[1] for s in states], lrs, wds,
                               beta1=self.beta1, beta2=self.beta2,
                               epsilon=self.epsilon, **self._common_kwargs())


@register
class RMSProp(Optimizer):
    """RMSProp, Tieleman-Hinton's or, with ``centered``, Graves' (parity:
    optimizer.py:488)."""

    fused = True
    _hyper_attrs = ("gamma1", "gamma2", "epsilon", "centered",
                    "clip_weights")

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (torch.zeros_like(weight), torch.zeros_like(weight), torch.zeros_like(weight))
        return (torch.zeros_like(weight),)

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        kw = dict(self._common_kwargs(), gamma1=self.gamma1,
                  epsilon=self.epsilon,
                  clip_weights=self.clip_weights or -1.0)
        if self.centered:
            _ops.multi_rmspropalex_update(
                weights, grads, [s[0] for s in states],
                [s[1] for s in states], [s[2] for s in states], lrs, wds,
                gamma2=self.gamma2, **kw)
        else:
            _ops.multi_rmsprop_update(weights, grads, [s[0] for s in states],
                                      lrs, wds, **kw)


@register
class AdaGrad(Optimizer):
    """AdaGrad (parity: optimizer.py:542)."""

    fused = True
    _hyper_attrs = ("float_stable_eps",)

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        _ops.multi_adagrad_update(weights, grads, states, lrs, wds,
                                  eps=self.float_stable_eps,
                                  **self._common_kwargs())


@register
class AdaDelta(Optimizer):
    """AdaDelta, which takes no learning rate (parity: optimizer.py:574);
    its accumulators are float32 whatever the weight's dtype, as there."""

    fused = True
    _hyper_attrs = ("rho", "epsilon")

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, dtype=torch.float32), torch.zeros_like(weight, dtype=torch.float32))

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        _ops.multi_adadelta_update(weights, grads, [s[0] for s in states],
                                   [s[1] for s in states], wds, rho=self.rho,
                                   epsilon=self.epsilon,
                                   **self._common_kwargs())


@register
class Ftrl(Optimizer):
    """FTRL-proximal (parity: optimizer.py:613); its ``z`` and ``n`` are
    float32, as there."""

    fused = True
    _hyper_attrs = ("lamda1", "beta")

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, dtype=torch.float32), torch.zeros_like(weight, dtype=torch.float32))

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        _ops.multi_ftrl_update(weights, grads, [s[0] for s in states],
                               [s[1] for s in states], lrs, wds,
                               lamda1=self.lamda1, beta=self.beta,
                               **self._common_kwargs())


@register
class Adamax(Optimizer):
    """Adamax, Adam under the infinity norm (parity: optimizer.py:643); its
    moments are float32, as there."""

    fused = True
    _hyper_attrs = ("beta1", "beta2")

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, dtype=torch.float32), torch.zeros_like(weight, dtype=torch.float32))

    def _multi_update(self, weights, grads, states, lrs, wds, ts):
        if isinstance(ts, torch.Tensor):
            lrs = lrs / (1.0 - _pow_each(self.beta1, ts.double()))
        else:
            lrs = [lr / (1.0 - self.beta1 ** t) for lr, t in zip(lrs, ts)]
        _ops.multi_adamax_update(weights, grads, [s[0] for s in states],
                                 [s[1] for s in states], lrs, wds,
                                 beta1=self.beta1, beta2=self.beta2,
                                 **self._common_kwargs())


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (parity: optimizer.py:680).  Its momentum
    schedule is one product over every update of every parameter, as
    there."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, dtype=torch.float32), torch.zeros_like(weight, dtype=torch.float32))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule *= momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t.copy_(self.beta1 * m_t + (1.0 - self.beta1) * grad)
        v_t.copy_(self.beta2 * v_t + (1.0 - self.beta2) * grad * grad)
        grad_prime = grad / (1.0 - self.m_schedule)
        m_t_prime = m_t / (1.0 - m_schedule_next)
        v_t_prime = v_t / (1.0 - self.beta2 ** t)
        m_t_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        weight.copy_(weight - lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (parity: optimizer.py:715):
    the noise comes from the port's generator for the weight's device."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prepped(grad)
        noise = torch.empty_like(weight).normal_(
            0, math.sqrt(lr), generator=_random.generator(weight.device))
        weight.copy_(weight - lr / 2 * (grad + wd * weight) + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (parity: optimizer.py:730)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous: Dict[Any, torch.Tensor] = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else torch.zeros_like(weight, dtype=torch.float32)
        return (mom, weight.detach().clone())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prepped(grad)
        mom, previous_weight = state
        comp = grad + wd * weight + self.lamda * grad * grad * (
            weight - previous_weight)
        if mom is not None:
            mom.copy_(self.momentum * mom - lr * comp)
            weight.copy_(weight + mom)
        else:
            weight.copy_(weight - lr * comp)
        previous_weight.copy_(weight)


@register
class Test(Optimizer):
    """The kvstore tests' optimizer (parity: optimizer.py:762): w += grad *
    rescale_grad, and the state keeps w."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight, dtype=torch.float32)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.copy_(weight + grad * self.rescale_grad)
        state.copy_(weight)


def _on_device(state, device):
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, (tuple, list)):
        return type(state)(_on_device(s, device) for s in state)
    return state


def _register_state(state) -> None:
    """Ledger-register the tensors of an optimizer state tree."""
    if isinstance(state, torch.Tensor):
        _memory.register(state, tag="optimizer_state")
    elif isinstance(state, (tuple, list)):
        for s in state:
            _register_state(s)


class Updater:
    """Applies an optimizer with per-index states (parity: optimizer.py:827,
    the per-key path)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        # False for a state loaded by set_states and not yet moved to its
        # weight's device
        self.states_synced: Dict[Any, bool] = {}

    def _ensure_state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
            if _memory.ENABLED:
                # optimizer state (momentum, Adam's moments, f32 masters)
                # is born here
                _register_state(self.states[index])
        elif not self.states_synced.get(index, False):
            self.states[index] = _on_device(self.states[index], weight.device)
            self.states_synced[index] = True

    def __call__(self, index, grad, weight):
        self._ensure_state(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        """Load ``get_states``' bytes, the port's or the JAX package's: the
        states, and the optimizer when the file carries one.  A file the
        port cannot read raises ``MXNetError`` and changes nothing."""
        states = _nd.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            states, optimizer = states
            if not isinstance(optimizer, Optimizer):
                raise MXNetError("the state file's optimizer is a "
                                 f"{type(optimizer).__name__}")
            self.optimizer = optimizer
        if not isinstance(states, dict):
            raise MXNetError("the state file holds a "
                             f"{type(states).__name__}, not a dict of states")
        self.states = states
        self.states_synced = dict.fromkeys(self.states, False)

    def get_states(self, dump_optimizer=False):
        if dump_optimizer:
            return _nd.dumps((self.states, self.optimizer))
        return _nd.dumps(self.states)


class HyperDeviceCache:
    """A captured step's hyper-parameters on the device (parity:
    ``mxnet_tpu/optimizer.py:HyperDeviceCache``): per key tuple, float64
    vectors of the learning rates and weight decays and the float64
    ``rescale_grad``, written in place (so their addresses, which a CUDA
    graph holds, never change) only when a schedule moves them: a
    last-value cache; and the applied-step counter ``t``, an int64 vector
    that the step advances on the device itself.  ``commit`` after each
    step records the counts the counter then stands for.  When the host's
    counts differ from them (a per-key update between two steps,
    ``load_states``) the counter is written again from the counts, or
    from ``pending_ts``, a checkpoint's applied-step vector (fp16's
    skipped steps make ``t`` lag the counts)."""

    def __init__(self):
        self._hc: Dict[tuple, dict] = {}
        self._ts: Dict[tuple, tuple] = {}  # (idx, device) -> (t, counts)

    def arrays(self, opt_, indices, device, pending_ts=None):
        """``(DeviceHypers, counts_t)`` for ``indices`` on ``device``.
        ``pending_ts``: a callable giving the int tuple to seed ``t`` from
        (called only when a seed happens), or None."""
        idx = tuple(indices)
        device = torch.device(device)
        key = (idx, device)
        ent = self._hc.get(key)
        if ent is None:
            n = len(idx)
            ent = self._hc[key] = {
                "lr": torch.empty(n, dtype=torch.float64, device=device),
                "wd": torch.empty(n, dtype=torch.float64, device=device),
                "rescale": torch.empty((), dtype=torch.float64,
                                       device=device),
                "lr_key": None, "wd_key": None, "rescale_key": None}
        for name, vals in (("lr", tuple(opt_._get_lr(i) for i in idx)),
                           ("wd", tuple(opt_._get_wd(i) for i in idx)),
                           ("rescale", float(opt_.rescale_grad))):
            if ent[name + "_key"] != vals:
                ent[name].copy_(torch.tensor(vals, dtype=torch.float64))
                ent[name + "_key"] = vals
        counts_t = tuple(opt_._index_update_count[i] for i in idx)
        tent = self._ts.get(key)
        if tent is None:
            tent = (torch.empty(len(idx), dtype=torch.int64, device=device),
                    None)
        ts = tent[0]
        if tent[1] != counts_t:
            seed = pending_ts() if pending_ts is not None else None
            ts.copy_(torch.tensor(counts_t if seed is None else seed,
                                  dtype=torch.int64))
        self._ts[key] = (ts, counts_t)
        return DeviceHypers(ent["lr"], ent["wd"], ts,
                            ent["rescale"]), counts_t

    def commit(self, indices, device, counts_t, steps: int = 1) -> None:
        """The step ran ``steps`` times: the counter now stands for the
        counts ``counts_t`` + ``steps``."""
        key = (tuple(indices), torch.device(device))
        ts, _ = self._ts[key]
        self._ts[key] = (ts, tuple(c + steps for c in counts_t))


class FusedUpdater(Updater):
    """Multi-tensor updater (parity: optimizer.py:954): ``update_all``
    steps every parameter of one device and dtype with one pass of
    ``torch._foreach_*`` ops.  The JAX package traces that step into one
    program; here it is a few kernels per group, whatever the number of
    parameters.  Per-key ``__call__`` stays available and runs the same
    arithmetic on a list of one."""

    def __init__(self, optimizer: Optimizer):
        super().__init__(optimizer)
        self.hyper_cache = HyperDeviceCache()
        #: the AMP policy of the last step through this updater ("f32"
        #: unless a whole step ran under MXNET_AMP); checkpoints stamp it
        self.dtype_policy = "f32"

    def update_all(self, indices, grads, weights) -> None:
        opt_ = self.optimizer
        if not opt_.fused:
            for i, g, w in zip(indices, grads, weights):
                self(i, g, w)
            return
        indices = list(indices)
        for i, w in zip(indices, weights):
            self._ensure_state(i, w)
        # the out-of-memory post-mortem chokepoint of the fused update,
        # with its two fault sites, fired before anything is written
        with trace_span("optimizer_update_all", cat="optimizer"), \
                _memory.oom_guard("optimizer.update_all"), \
                _metrics.dispatch_unit("update"):
            _fi_fire("memory.oom", at="optimizer")
            _fi_fire("device.unavailable", at="optimizer")
            for i in indices:
                opt_._update_count(i)
            groups: Dict[tuple, list] = {}
            for i, g, w in zip(indices, grads, weights):
                mp = opt_.multi_precision and _is_low_prec(w.dtype)
                groups.setdefault((w.device, w.dtype, mp),
                                  []).append((i, g, w))
            note = self._note_key(opt_, groups)
            with _introspect.counting("fused_update", signature=note) \
                    if note is not None else _NULL, \
                    _introspect.layer_scope("optimizer"):
                for (_, _, mp), items in groups.items():
                    idx = [i for i, _, _ in items]
                    opt_.fused_step(idx, [w for _, _, w in items],
                                    [g for _, g, _ in items],
                                    [self.states[i] for i in idx], mp)

    def _note_key(self, opt_, groups):
        """The introspector's signature of this update's program, the
        first time this parameter layout runs (None after)."""
        if not _introspect.ENABLED:
            return None
        key = (type(opt_).__name__, tuple(
            (str(dt), mp, tuple((tuple(w.shape)) for _, _, w in items))
            for (_, dt, mp), items in groups.items()))
        noted = self.__dict__.setdefault("_noted_keys", set())
        if key in noted:
            return None
        noted.add(key)
        return hashlib.sha1(repr(key).encode()).hexdigest()[:16]


_NULL = contextlib.nullcontext()


def get_updater(optimizer: Optimizer) -> FusedUpdater:
    return FusedUpdater(optimizer)
