"""Imperative autograd: record/pause scopes, backward, grad, Function.

The counterpart of ``mxnet_tpu/autograd.py``.  The JAX package keeps a tape
of per-op vjp closures; the port's arrays are ``torch.Tensor``s, so it
records through torch's autograd and keeps MXNet's semantics on top:

* **No graph outside ``record()``.**  ``record()`` turns torch's grad mode
  on and ``pause()`` turns it off, for the scope, and a gluon ``Block``
  runs with grad mode equal to the recording flag, so scoring, generation
  and serving build no graph though parameters require gradients.
* **``grad_req``.**  A variable marked with ``"write"`` has its gradient
  buffer overwritten by each backward that reaches it, ``"add"``
  accumulates, ``"null"`` takes no gradient.  Torch always accumulates
  into ``.grad``: a hook on each variable, which torch calls once per
  backward with the variable's whole gradient, zeroes a ``"write"``
  buffer just before torch adds the gradient into it, and marks the
  gradient fresh (the Trainer's stale-gradient check reads the mark).
  The buffer stays the same tensor, so ``mark_variables``' buffers fill
  in place.  This holds for torch's own ``Tensor.backward`` as well.
* ``is_training()`` is MXNet's train-mode flag, separate from recording;
  ops read it through ``__is_train__``.
* **``head.backward()``** is ``NDArray.backward``: ones as the head
  gradient whatever the head's shape, so ``loss.backward()`` works on a
  Gluon loss's per-sample vector, and a head that carries no recorded
  graph passes nothing.  The port's arrays are plain tensors, so importing
  this module extends ``torch.Tensor.backward`` in just the two cases
  where torch raises (no ``gradient`` and a head of more than one element,
  or a head that requires no gradient); every call torch accepts runs
  unchanged.

Where the port differs from the reference (``ROADMAP.md`` §3): a variable
must be marked (``nd.attach_grad`` / ``mark_variables``) before the ops
that use it are recorded; an in-place write to a recorded variable raises
where the reference differentiates the value it had when recorded; ops
called on a variable outside ``record()`` and outside any Block build a
torch graph (which nothing reads).
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(is_record: bool) -> bool:
    """Set the recording flag (and torch's grad mode with it); returns the
    previous flag."""
    old, _state.recording = _state.recording, bool(is_record)
    torch.set_grad_enabled(_state.recording)
    return old


def set_training(train_mode: bool) -> bool:
    old, _state.training = _state.training, bool(train_mode)
    return old


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter = (is_record, train_mode)
        self._prev = None

    def __enter__(self):
        rec, train = self._enter
        self._prev = (_state.recording, _state.training,
                      torch.is_grad_enabled())
        if rec is not None:
            _state.recording = rec
            torch.set_grad_enabled(rec)
        if train is not None:
            _state.training = train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training, grad_mode = self._prev
        torch.set_grad_enabled(grad_mode)


def record(train_mode: bool = True):
    """Scope in which executed ops are recorded (parity: autograd.py:122)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# ---------------------------------------------------------------------------
# variables and their gradient buffers
# ---------------------------------------------------------------------------
_GRAD_REQS = ("write", "add", "null")


def _deposit_hook(var):
    ref = weakref.ref(var)

    def hook(grad):
        v = ref()
        if v is None:
            return None
        if v._mx_grad_req == "write" and v.grad is not None:
            v.grad.zero_()        # torch adds this backward's gradient next
        v._mx_fresh_grad = True
        return None
    return hook


def mark_variable(var: torch.Tensor, grad, grad_req: str = "write") -> None:
    """Make ``var`` a variable whose gradient lands in ``grad`` (a tensor
    shaped like it, or None to let the first backward allocate it)."""
    if grad_req not in _GRAD_REQS:
        raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, got "
                         f"{grad_req!r}")
    if var.grad_fn is not None:
        raise MXNetError("a variable must be a tensor that no recorded op "
                         "produced; detach() it first")
    var._mx_grad_req = grad_req
    var._mx_fresh_grad = False
    if grad_req == "null":
        var.requires_grad_(False)
        var.grad = None
        return
    var.requires_grad_(True)
    var.grad = grad
    if getattr(var, "_mx_hooked", False):
        return
    var.register_hook(_deposit_hook(var))
    var._mx_hooked = True


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Parity: autograd.mark_variables."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        mark_variable(v, g, req)


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Gradients of ``heads`` into the marked variables (parity:
    Imperative::Backward).  A head's gradient defaults to ones.  Heads that
    carry no recorded graph contribute nothing.  ``train_mode`` is
    accepted for the signature: torch fixes each op's backward when the op
    runs."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    if head_grads is None or isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads] * len(heads)
    tensors, grads = [], []
    for h, g in zip(heads, head_grads):
        if h.requires_grad:
            tensors.append(h)
            grads.append(torch.ones_like(h) if g is None
                         else torch.as_tensor(g, dtype=h.dtype,
                                              device=h.device))
    if tensors:
        torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


_torch_backward = torch.Tensor.backward


def _tensor_backward(self, gradient=None, retain_graph=None,
                     create_graph=False, inputs=None):
    """``torch.Tensor.backward`` with ``NDArray.backward``'s defaults where
    torch would raise: with no ``gradient``, a head of more than one
    element takes ones, and a head that requires no gradient (no recorded
    graph) is a no-op, as ``backward`` treats it."""
    if gradient is None and inputs is None:
        if not self.requires_grad:
            return
        if self.numel() != 1:
            gradient = torch.ones_like(self)
    _torch_backward(self, gradient, retain_graph, create_graph, inputs)


_tensor_backward.__doc__ = (_tensor_backward.__doc__ + "\n\n"
                            + (_torch_backward.__doc__ or ""))
torch.Tensor.backward = _tensor_backward


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of heads with respect to variables, deposited as
    ``backward`` deposits them; returns the variables' gradient buffers."""
    if create_graph:
        raise MXNetError("create_graph=True not supported yet")
    for v in variables:
        if not v.requires_grad:
            raise MXNetError(
                "autograd.grad: a variable was not marked when its ops were "
                "recorded (the port records through torch: call "
                "nd.attach_grad before record())")
    backward(heads, head_grads, retain_graph=bool(retain_graph),
             train_mode=train_mode)
    return [v.grad for v in variables]


def get_symbol(x):
    raise MXNetError("autograd.get_symbol is not supported; use gluon "
                     "HybridBlock tracing instead")


# ---------------------------------------------------------------------------
# Custom differentiable Function (parity: autograd.Function, autograd.py:270)
# ---------------------------------------------------------------------------
class _Bridge(torch.autograd.Function):
    """Runs an MXNet-style ``Function`` as one torch autograd node."""

    @staticmethod
    def forward(ctx, func, *inputs):
        ctx.func = func
        with pause():
            outputs = func.forward(*inputs)
        return outputs if isinstance(outputs, torch.Tensor) \
            else tuple(outputs)

    @staticmethod
    def backward(ctx, *output_grads):
        with pause():
            gin = ctx.func.backward(*output_grads)
        gin = (gin,) if isinstance(gin, torch.Tensor) else tuple(gin)
        return (None,) + gin


class Function:
    """User-defined op with explicit forward/backward over tensors:
    ``forward`` and ``backward`` run with recording paused, and
    ``save_for_backward`` keeps tensors on the instance."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        outputs = _Bridge.apply(self, *inputs)
        return outputs if isinstance(outputs, torch.Tensor) \
            else list(outputs)
