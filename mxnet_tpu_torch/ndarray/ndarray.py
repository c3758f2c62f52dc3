"""Tensor creation, host copies and files for the ``nd`` namespace.

The port's arrays are plain ``torch.Tensor``s: these functions give them
MXNet's constructors (``array`` and ``zeros`` with ``ctx=`` and ``dtype=``),
``asnumpy``, and ``save`` / ``load`` / ``load_frombuffer``.  ``ctx`` is a
Context, a torch.device or None (the current context, ``gpu(0)`` unless the
caller entered another).

Files are the JAX package's ``.npz`` container, so either package reads
what the other wrote: one tensor under ``__mx_single__``, a list under
``__mx_list_000000``..., a dict under its own keys.  bfloat16 is stored as
``ml_dtypes.bfloat16``, which numpy writes as 2-byte void (``|V2``); the
reader takes every ``|V2`` array back as bfloat16.
"""
from __future__ import annotations

import io
import os
import struct

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


# ---------------------------------------------------------------------------
# save / load (parity API: mx.nd.save/load, src/c_api/c_api.cc:307,330)
# ---------------------------------------------------------------------------
# the reference-era binary container (dmlc list, kMXAPINDArrayListMagic)
_REFERENCE_LIST_MAGIC = 0x112


def save(fname: str, data) -> None:
    """Save a tensor, a list or a dict of tensors to one ``.npz`` file.

    The file is written beside ``fname`` and moved over it with one
    ``os.replace``: a crash mid-save never leaves a torn file there."""
    if isinstance(data, torch.Tensor):
        payload = {"__mx_single__": asnumpy(data)}
    elif isinstance(data, dict):
        payload = {k: asnumpy(v) for k, v in data.items()}
    elif isinstance(data, (list, tuple)):
        payload = {f"__mx_list_{i:06d}": asnumpy(v) for i, v in enumerate(data)}
    else:
        raise MXNetError("save expects a tensor, a list or a dict of tensors")
    tmp = f"{fname}.tmp-{os.getpid()}"
    _np.savez(tmp, **payload)  # numpy appends .npz
    os.replace(tmp + ".npz", fname)


def _check_container(head: bytes, origin) -> None:
    if len(head) >= 8 and \
            struct.unpack("<Q", head[:8])[0] == _REFERENCE_LIST_MAGIC:
        raise NotImplementedError(
            f"{origin}: the reference-era binary .params format is not "
            "ported yet (ROADMAP.md, queue item 6: sparse storage and the "
            "reference-era format)")


def _host_array(a: _np.ndarray) -> _np.ndarray:
    if a.dtype == _np.dtype("V2"):
        if bfloat16 is None:
            raise MXNetError("a bfloat16 array in the file requires ml_dtypes")
        return a.view(bfloat16)
    return a


def _unpack(z):
    """The file's contents as numpy arrays: one, a list or a dict."""
    keys = list(z.keys())
    if keys == ["__mx_single__"]:
        return _host_array(z["__mx_single__"])
    if all(k.startswith("__mx_list_") for k in keys):
        return [_host_array(z[k]) for k in sorted(keys)]
    return {k: _host_array(z[k]) for k in keys}


def load_numpy(fname: str):
    """``load`` without the device: the file's arrays as numpy arrays."""
    with open(fname, "rb") as f:
        _check_container(f.read(8), fname)
    with _np.load(fname, allow_pickle=False) as z:
        return _unpack(z)


def _to_tensors(host, ctx):
    if isinstance(host, list):
        return [array(a, ctx=ctx) for a in host]
    if isinstance(host, dict):
        return {k: array(a, ctx=ctx) for k, a in host.items()}
    return array(host, ctx=ctx)


def load(fname: str, ctx=None):
    """What ``save`` wrote, as tensors on ``ctx`` (default: the current
    context)."""
    return _to_tensors(load_numpy(fname), ctx)


def load_frombuffer(buf, ctx=None):
    """``load`` from an in-memory copy of the file (parity:
    MXNDArrayLoadFromBuffer)."""
    buf = bytes(buf)
    _check_container(buf, "<buffer>")
    with _np.load(io.BytesIO(buf), allow_pickle=False) as z:
        return _to_tensors(_unpack(z), ctx)
