"""Device contexts: mx.cpu()/mx.gpu() mapped onto torch devices.

The counterpart of ``mxnet_tpu/context.py``.  ``gpu(i)`` is CUDA device i
and is the default context.  ``cpu()`` is honoured only when the caller asks
for it; ``cpu_pinned()`` is host memory that the constructors of ``nd`` pin
(page-locked, for asynchronous copies to the card) when CUDA is present.  There is no fallback: resolving ``gpu(i)`` on a machine without
that CUDA device raises ``MXNetError`` instead of running on the CPU.
"""
from __future__ import annotations

import torch

from .base import MXNetError, _ThreadLocalStack

_DEVICE_TYPES = ("cpu", "cpu_pinned", "gpu")


class Context:
    """A device context. Comparable/hashable; usable as a with-scope."""

    _stack = _ThreadLocalStack()
    default_ctx: "Context"

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in _DEVICE_TYPES:
            raise MXNetError(f"unknown device type {device_type}")
        self.device_type = device_type
        self.device_id = device_id

    def torch_device(self) -> torch.device:
        """Resolve to a torch.device; raises when a gpu context names a CUDA
        device this process cannot see."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if self.device_id >= n:
            raise MXNetError(
                f"{self} is not available: {n} CUDA device(s) visible.  "
                "Pass ctx=mx.cpu() explicitly to run on the CPU")
        return torch.device("cuda", self.device_id)

    # -- scope --------------------------------------------------------------
    def __enter__(self):
        Context._stack.push(self)
        return self

    def __exit__(self, *exc):
        Context._stack.pop()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __str__(self):
        return self.__repr__()


Context.default_ctx = Context("gpu", 0)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Pinned host memory (``pin`` below)."""
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The number of CUDA devices this process sees."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def pin(t: torch.Tensor, ctx) -> torch.Tensor:
    """``t`` page-locked when ``ctx`` (None: the current context) is
    ``cpu_pinned`` and CUDA is present (without CUDA there is nothing to
    pin for)."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context) and ctx.device_type == "cpu_pinned" \
            and torch.cuda.is_available():
        return t.pin_memory()
    return t


def gpu(device_id: int = 0) -> Context:
    """CUDA device ``device_id``; raises on use when it is not visible."""
    ctx = Context("gpu", device_id)
    ctx.torch_device()
    return ctx


def current_context() -> Context:
    return Context._stack.top() or Context.default_ctx


def as_device(ctx=None) -> torch.device:
    """The torch.device for a Context, a torch.device, a device string, or
    (None) the current context."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return ctx.torch_device()
    return torch.device(ctx)
