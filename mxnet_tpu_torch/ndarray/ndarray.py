"""Tensor creation and host copies for the ``nd`` namespace.

The port's arrays are plain ``torch.Tensor``s: these functions give them
MXNet's constructors (``array`` and ``zeros`` with ``ctx=`` and ``dtype=``)
and ``asnumpy``.  ``ctx`` is a Context, a torch.device or None
(the current context, ``gpu(0)`` unless the caller entered another).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, bfloat16, np_dtype, torch_dtype
from ..context import as_device


def _from_numpy(src: _np.ndarray) -> torch.Tensor:
    if bfloat16 is not None and src.dtype == bfloat16:
        return torch.from_numpy(_np.ascontiguousarray(src).view(_np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(_np.ascontiguousarray(src))


def array(source_array, ctx=None, dtype=None) -> torch.Tensor:
    """A new tensor from a tensor, numpy array, list or scalar.  Keeps a
    tensor's or numpy array's dtype; lists and scalars default to float32
    (parity: mx.nd.array)."""
    device = as_device(ctx)
    if isinstance(source_array, torch.Tensor):
        dt = source_array.dtype if dtype is None else torch_dtype(dtype)
        return source_array.detach().to(device=device, dtype=dt, copy=True)
    src = _np.asarray(source_array)
    if dtype is None:
        dtype = src.dtype if isinstance(source_array, _np.ndarray) \
            else _np.float32
    return _from_numpy(src.astype(np_dtype(dtype))).to(device)


def zeros(shape, ctx=None, dtype=None) -> torch.Tensor:
    if isinstance(shape, int):
        shape = (shape,)
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                       device=as_device(ctx))


def asnumpy(x: torch.Tensor) -> _np.ndarray:
    """A host copy; bfloat16 comes back as an ``ml_dtypes.bfloat16`` array."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        if bfloat16 is None:
            raise MXNetError("a bfloat16 host copy requires ml_dtypes")
        return x.view(torch.int16).numpy().view(bfloat16)
    return x.numpy()
