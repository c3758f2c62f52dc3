"""Tensor creation, host copies, free functions and files for the ``nd``
namespace.

The port's arrays are plain ``torch.Tensor``s: these functions give them
MXNet's constructors (``array``, ``zeros``, ``ones``, ``full``, ``empty``,
``arange``, ``eye``, ``from_numpy``, ``from_dlpack`` with ``ctx=`` and
``dtype=``), ``asnumpy``, ``attach_grad`` / ``grad``, ``moveaxis``,
``concatenate``, ``onehot_encode``, ``waitall``, and ``save`` / ``load`` /
``load_frombuffer``.  ``ctx`` is a Context, a torch.device or None (the
current context, ``gpu(0)`` unless the caller entered another).

The binary free functions (``add``, ``power``, ``maximum``, ``greater``,
``modulo``, ...) take tensors or Python numbers on either side and run
the registered op: comparisons give 1.0/0.0 in the input's dtype, as
MXNet's do.  Python's operators on the port's tensors stay torch's
(``a > b`` is bool).

Files are the JAX package's ``.npz`` container, so either package reads
what the other wrote: one tensor under ``__mx_single__``, a list under
``__mx_list_000000``..., a dict under its own keys.  bfloat16 is stored as
``ml_dtypes.bfloat16``, which numpy writes as 2-byte void (``|V2``); the
reader takes every ``|V2`` array back as bfloat16.
"""
from __future__ import annotations

import io
import os
import pickle
import struct

import numpy as _np
import torch
import torch.utils.dlpack

from ..analysis import sanitizer as _san
from ..base import MXNetError, bfloat16, np_dtype, torch_dtype
from ..context import as_device, pin


_RAW_BF16 = _np.dtype("V2")


def _from_numpy(src: _np.ndarray) -> torch.Tensor:
    """A tensor over a host array; ``ml_dtypes.bfloat16`` and 2-byte raw
    (``|V2``, how numpy stores bfloat16) both become bfloat16."""
    if src.dtype == _RAW_BF16 or (bfloat16 is not None
                                  and src.dtype == bfloat16):
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
        return pin(source_array.detach().to(device=device, dtype=dt,
                                            copy=True), ctx)
    src = _np.asarray(source_array)
    if dtype is None:
        dtype = src.dtype if isinstance(source_array, _np.ndarray) \
            else _np.float32
    return pin(_from_numpy(src.astype(np_dtype(dtype))).to(device), ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kw) -> torch.Tensor:
    """Zeros; keywords the JAX package's ``zeros`` ignores (``name``,
    ``stype``, a cell's ``__layout__``) are ignored here too."""
    return pin(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                           device=as_device(ctx)), ctx)


def ones(shape, ctx=None, dtype=None, **kw) -> torch.Tensor:
    return pin(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                          device=as_device(ctx)), ctx)


def full(shape, val, ctx=None, dtype=None, **kw) -> torch.Tensor:
    return pin(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                          device=as_device(ctx)), ctx)


def empty(shape, ctx=None, dtype=None) -> torch.Tensor:
    """Zeros, as the JAX package's ``empty`` gives."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> torch.Tensor:
    """[start, stop) by ``step`` (one argument: [0, start)), each value
    ``repeat`` times; float32 unless ``dtype`` says otherwise."""
    from .register import invoke
    return invoke("_arange", [], dict(start=start, stop=stop, step=step,
                                      repeat=repeat, ctx=ctx,
                                      dtype=dtype or "float32"))


def eye(N, M=0, k=0, ctx=None, dtype=None) -> torch.Tensor:
    from .register import invoke
    return invoke("_eye", [], dict(N=N, M=M, k=k, ctx=ctx,
                                   dtype=dtype or "float32"))


def from_numpy(a, zero_copy=False) -> torch.Tensor:
    """A copy of numpy array ``a`` on the current context, in its dtype."""
    return array(a)


def from_dlpack(capsule) -> torch.Tensor:
    """The tensor a DLPack capsule (or an object with ``__dlpack__``)
    describes, sharing its memory."""
    return torch.utils.dlpack.from_dlpack(capsule)


def moveaxis(a: torch.Tensor, source, destination) -> torch.Tensor:
    return torch.movedim(a, source, destination)


def concatenate(arrays, axis=0, always_copy=True) -> torch.Tensor:
    return torch.cat(list(arrays), dim=axis)


def onehot_encode(indices, out) -> torch.Tensor:
    """Write the one-hot rows of ``indices`` (depth ``out.shape[1]``) into
    ``out`` and return it (MXNet's deprecated form of ``one_hot``)."""
    from .register import invoke
    with torch.no_grad():
        out.copy_(invoke("one_hot", [indices], {"depth": out.shape[1]}))
    return out


def waitall() -> None:
    """Wait for every queued operation: a synchronisation of each CUDA
    device this process has used (work on the CPU has finished when its
    call returns).  Inside ``analysis.no_sync()`` it raises
    ``SyncViolation`` (under ``MXNET_SANITIZE=1``)."""
    _san.check_sync("nd.waitall")
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _binary(op, scalar_op, rscalar_op, py=None):
    """MXNet's binary function: the broadcast op ``op`` on two tensors,
    ``scalar_op`` with a number on the right, ``rscalar_op`` with a number
    on the left (a comparison is mirrored there: ``greater(2, x)`` is
    ``x < 2``); ``py`` on two numbers, where MXNet computes them."""
    def fn(lhs, rhs):
        from .register import invoke
        if isinstance(lhs, torch.Tensor):
            if isinstance(rhs, torch.Tensor):
                return invoke(op, [lhs, rhs], {})
            return invoke(scalar_op, [lhs], {"scalar": float(rhs)})
        if isinstance(rhs, torch.Tensor):
            return invoke(rscalar_op, [rhs], {"scalar": float(lhs)})
        if py is None:
            raise TypeError("at least one operand must be a tensor")
        return py(lhs, rhs)
    fn.__name__ = op
    return fn


add = _binary("broadcast_add", "_plus_scalar", "_plus_scalar",
              lambda a, b: a + b)
subtract = _binary("broadcast_sub", "_minus_scalar", "_rminus_scalar",
                   lambda a, b: a - b)
multiply = _binary("broadcast_mul", "_mul_scalar", "_mul_scalar",
                   lambda a, b: a * b)
divide = _binary("broadcast_div", "_div_scalar", "_rdiv_scalar",
                 lambda a, b: a / b)
true_divide = divide
power = _binary("broadcast_power", "_power_scalar", "_rpower_scalar",
                lambda a, b: a ** b)
pow = power
modulo = _binary("broadcast_mod", "_mod_scalar", "_rmod_scalar")
maximum = _binary("broadcast_maximum", "_maximum_scalar", "_maximum_scalar",
                  max)
minimum = _binary("broadcast_minimum", "_minimum_scalar", "_minimum_scalar",
                  min)
hypot = _binary("broadcast_hypot", "_hypot_scalar", "_hypot_scalar",
                lambda a, b: (a * a + b * b) ** 0.5)
equal = _binary("broadcast_equal", "_equal_scalar", "_equal_scalar")
not_equal = _binary("broadcast_not_equal", "_not_equal_scalar",
                    "_not_equal_scalar")
greater = _binary("broadcast_greater", "_greater_scalar", "_lesser_scalar")
greater_equal = _binary("broadcast_greater_equal", "_greater_equal_scalar",
                        "_lesser_equal_scalar")
lesser = _binary("broadcast_lesser", "_lesser_scalar", "_greater_scalar")
lesser_equal = _binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                       "_greater_equal_scalar")


def asnumpy(x: torch.Tensor) -> _np.ndarray:
    """A host copy, also of a CPU tensor (which the optimizers update in
    place); bfloat16 comes back as an ``ml_dtypes.bfloat16`` array.  A
    device-to-host read: ``analysis.no_sync()`` regions forbid it."""
    _san.check_sync("nd.asnumpy")
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        if bfloat16 is None:
            raise MXNetError("a bfloat16 host copy requires ml_dtypes")
        return x.view(torch.int16).numpy().view(bfloat16)
    return x.numpy()


def asscalar(x: torch.Tensor):
    """The Python number of a one-element tensor (parity:
    ``NDArray.asscalar``); a device-to-host read."""
    if x.numel() != 1:
        raise ValueError("The current array is not a scalar")
    _san.check_sync("nd.asscalar")
    return x.item()


def host_copy(x: torch.Tensor) -> _np.ndarray:
    """An owned host copy that needs no ``ml_dtypes``: bfloat16 comes back
    as 2-byte raw data (``|V2``), which ``array`` and ``_rebuild_ndarray``
    read back as bfloat16."""
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_RAW_BF16)
    return x.numpy()


def attach_grad(x: torch.Tensor, grad_req: str = "write") -> torch.Tensor:
    """Make ``x`` an autograd variable with a zeroed gradient buffer
    (parity: NDArray.attach_grad); ``grad_req`` is "write", "add" or
    "null".  Returns ``x``."""
    from ..autograd import mark_variable
    mark_variable(x, None if grad_req == "null" else torch.zeros_like(x),
                  grad_req)
    return x


def grad(x: torch.Tensor):
    """``x``'s gradient buffer (parity: NDArray.grad); None unless
    ``attach_grad`` or ``autograd.mark_variables`` made it a variable."""
    return x.grad if x.is_leaf else None


# ---------------------------------------------------------------------------
# save / load (parity API: mx.nd.save/load, src/c_api/c_api.cc:307,330)
# ---------------------------------------------------------------------------
# the reference-era binary container (dmlc list, kMXAPINDArrayListMagic)
_REFERENCE_LIST_MAGIC = 0x112


def write_atomic(fname: str, payload: bytes) -> None:
    """Write ``payload`` beside ``fname`` and move it over ``fname`` with
    one ``os.replace``: a crash mid-write never leaves a torn file there."""
    tmp = f"{fname}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, fname)


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


# ---------------------------------------------------------------------------
# pickling (updater states, ``Trainer.save_states``)
# ---------------------------------------------------------------------------
def _rebuild_ndarray(np_data, dev_type, dev_id):
    """The target of the JAX package's ``NDArray.__reduce__``
    (``mxnet_tpu/ndarray/ndarray.py:555-561``) and of the port's own
    reducer: a CPU tensor.  An updater moves each state onto its weight's
    device when it first uses it, so a file written on a card loads on a
    machine without one and resumes there, and the other way round."""
    return array(np_data, ctx=torch.device("cpu"), dtype=np_data.dtype)


class _StatePickler(pickle.Pickler):
    """Writes tensors as ``_rebuild_ndarray(numpy, dev_type, dev_id)``, the
    reducer shape of the JAX package's NDArray, never as torch storages;
    bfloat16 as 2-byte raw data."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            dev = obj.device
            return _rebuild_ndarray, (
                host_copy(obj), "gpu" if dev.type == "cuda" else "cpu",
                dev.index or 0)
        return NotImplemented


def dumps(obj) -> bytes:
    """``pickle.dumps`` with tensors written as host arrays."""
    buf = io.BytesIO()
    _StatePickler(buf).dump(obj)
    return buf.getvalue()


# what a state file may name: the port's own classes at the JAX package's
# module paths, numpy's array and scalar reconstructors, and plain builtins
_PORT_MODULES = ("optimizer", "lr_scheduler", "gluon.parameter", "context",
                 "initializer")
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("_reconstruct", "scalar", "dtype", "ndarray", "_frombuffer")
_BUILTINS = {("builtins", n) for n in (
    "set", "frozenset", "complex", "slice", "range", "bytearray", "bytes",
    "tuple", "list", "dict", "int", "float", "bool", "str", "object")} | {
    ("collections", "OrderedDict"), ("copyreg", "_reconstructor")}


class _Dropped:
    """A graph node a state file carries that the port drops on load: the
    JAX package's ``Parameter`` pickles its symbol variable once the net
    was traced (a whole step traces it), and the port's ``Parameter``
    rebuilds its own."""

    def __setstate__(self, state):
        pass


class _StateUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("ml_dtypes"):
            raise MXNetError(
                f"the state file holds {module}.{name} arrays (bfloat16 "
                "written by the JAX package through ml_dtypes); the port "
                "reads bfloat16 only as 2-byte raw data and does not need "
                "ml_dtypes")
        package, _, rel = module.partition(".")
        if package in ("mxnet_tpu", "mxnet_tpu_torch"):
            module = f"mxnet_tpu_torch.{rel}"
            if (rel, name) == ("ndarray.ndarray", "_rebuild_ndarray"):
                return _rebuild_ndarray
            if rel == "symbol.symbol" and name in ("Symbol", "_Node"):
                return _Dropped
            if rel in _PORT_MODULES:
                import importlib
                obj = getattr(importlib.import_module(module), name, None)
                if isinstance(obj, type):
                    return obj
            raise MXNetError(f"the state file names {module}.{name}, which "
                             "the port does not have or does not load")
        if module in _NUMPY_MODULES and (
                name in _NUMPY_NAMES or isinstance(
                    getattr(_np, name, None), type) and issubclass(
                        getattr(_np, name), _np.generic)):
            return super().find_class(module, name)
        if (module, name) in _BUILTINS:
            return super().find_class(module, name)
        raise MXNetError(f"the state file names {module}.{name}, which a "
                         "state file may not load")


def loads(payload: bytes):
    """Read what ``dumps`` or the JAX package's ``pickle.dumps`` of
    updater states wrote, allowing only the port's own classes (a path in
    the JAX package read as the same path in the port), numpy and builtins;
    anything else raises ``MXNetError``, and nothing is returned."""
    return _StateUnpickler(io.BytesIO(payload)).load()
