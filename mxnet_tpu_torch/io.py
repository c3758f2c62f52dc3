"""Data iterators (parity: python/mxnet/io.py and src/io/).

The counterpart of ``mxnet_tpu/io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter`` (a
background thread that keeps the next batches ready), ``MNISTIter`` (local
idx files) and ``CSVIter``.

``NDArrayIter`` keeps the JAX package's order: ``shuffle`` permutes with
numpy's global RNG, ``last_batch_handle`` is ``pad``, ``discard`` or
``roll_over``.  A source that is a tensor stays where it is and each batch
is sliced from it on its device (a view, or a gather for a shuffled or
wrapped batch): a source resident on the card never goes through the host.
A numpy source gives CPU tensors, which ``Module`` copies into its bound
buffers on the card.

The record-file iterators: ``ImageRecordIter`` (``image.ImageIter`` over a
``.rec`` behind a ``PrefetchingIter``, optionally with the augmentation's
float work on the device), ``ImageDetRecordIter`` (``detection``) and
``TensorRecordIter``, whose batches the native runtime's loader thread
(``_native``, ``src/runtime/prefetch.cc``) assembles from raw-tensor
records off the GIL.  Their batches land on the iterator's context
(``ctx``, else the current context when it is built).

Not ported, and raising ``NotImplementedError`` that names the queue item
(ROADMAP.md): ``LibSVMIter`` waits for sparse storage (item 6).
"""
from __future__ import annotations

import ctypes
import gzip
import os
import struct
import time
from collections import namedtuple
from typing import List

import numpy as _np
import torch

from .base import MXNetError, getenv, np_dtype
from .context import as_device
from .ndarray.ndarray import _from_numpy
from .observability import metrics as _metrics

DataDesc = namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])
DataDesc.__new__.__defaults__ = (_np.float32, "NCHW")


class DataBatch:
    """One batch (parity: io.py DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [tuple(d.shape) for d in self.data]
        label_shapes = [tuple(l.shape) for l in self.label] \
            if self.label else None
        return f"{self.__class__.__name__}: data shapes: {data_shapes} " \
               f"label shapes: {label_shapes}"


class DataIter:
    """Base iterator (parity: io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """[(name, source)]: tensors stay tensors, the rest becomes numpy."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, torch.Tensor)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError("Input must be a tensor, numpy.ndarray, list or "
                         "dict")
    return [(k, v if isinstance(v, torch.Tensor) else _np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (parity: io.py:545)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        if shuffle:
            _np.random.shuffle(self.idx)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        assert self.num_data >= batch_size, \
            "batch_size must be smaller than data size"
        self.cursor = -batch_size
        self.batch_size = batch_size

    def _descs(self, sources) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         np_dtype(v.dtype)) for k, v in sources]

    @property
    def provide_data(self) -> List[DataDesc]:
        return self._descs(self.data)

    @property
    def provide_label(self) -> List[DataDesc]:
        return self._descs(self.label)

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None,
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)
        raise StopIteration

    def _getdata(self, sources):
        assert self.cursor < self.num_data, "DataIter needs reset."
        lo, hi = self.cursor, self.cursor + self.batch_size
        contiguous = hi <= self.num_data
        if contiguous:
            sel = self.idx[lo:hi]
        else:
            sel = _np.concatenate([self.idx[lo:],
                                   self.idx[:hi - self.num_data]])
        out = []
        for _, src in sources:
            if isinstance(src, torch.Tensor):
                if contiguous and not self.shuffle:
                    out.append(src[lo:hi])
                else:
                    out.append(src.index_select(0, torch.as_tensor(
                        sel, device=src.device)))
            else:
                out.append(_from_numpy(src[sel]))
        return out

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize another iterator to ``size`` batches per epoch (parity:
    io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad



class PrefetchingIter(DataIter):
    """Read ahead of the consumer in a background thread (parity: io.py
    PrefetchingIter, src/io/iter_prefetcher.h): up to ``depth`` batches of
    the wrapped iterator wait in a queue, behind the shared
    ``gluon.data.prefetcher.AsyncPrefetcher``.  An exception in the thread
    is raised to the consumer, then ``StopIteration``.  With ``device`` (a
    Context or torch.device) the thread also copies each batch there
    (pinned staging, a side stream, the consumer's stream waiting on the
    copy): the next batch is on the card before the training loop asks for
    it.  The core's fault containment rides along: a transient source IO
    error respawns the worker once, and ``skip_budget`` (default
    ``MXNET_DATA_SKIP_BUDGET``) skips corrupt records
    (``resilience.DataCorruptionError``) instead of ending the epoch."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 depth=None, device=None, skip_budget=None):
        if not isinstance(iters, list):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter takes one iterator")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = int(depth) if depth is not None \
            else int(getenv("MXNET_PREFETCH_DEPTH", 2))
        self._device = device
        self._skip_budget = skip_budget
        self._pf = None
        self._start()

    def _renamed(self, descs, rename):
        if rename is None:
            return descs
        return [DataDesc(rename[0].get(d.name, d.name), d.shape, d.dtype)
                for d in descs]

    @property
    def provide_data(self):
        return self._renamed(self.iter.provide_data, self.rename_data)

    @property
    def provide_label(self):
        return self._renamed(self.iter.provide_label, self.rename_label)

    def _start(self):
        from .gluon.data.prefetcher import (AsyncPrefetcher,
                                            _device_put_batch,
                                            _resolve_device)
        transform = None
        if self._device is not None:
            dev = _resolve_device(self._device)
            transform = lambda b: _device_put_batch(b, dev)  # noqa: E731
        self._pf = AsyncPrefetcher(self.iter.next, depth=self._depth,
                                   transform=transform,
                                   skip_budget=self._skip_budget)

    # tells BaseModule.fit this iterator records its own consumer-side
    # stall, so fit does not observe the same wait again
    _self_timed_data_wait = True

    def next(self):
        if self._pf is None:
            raise StopIteration
        on = _metrics.ENABLED
        t0 = time.perf_counter() if on else 0.0
        try:
            return self._pf.get()
        finally:
            if on:
                _metrics.DATA_WAIT_SECONDS.observe(time.perf_counter() - t0)

    def iter_next(self):
        raise NotImplementedError

    def reset(self):
        self.close()
        self.iter.reset()
        self._start()

    def close(self):
        """Stop the thread and drop what it read ahead."""
        if self._pf is None:
            return
        self._pf.close()
        self._pf = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _read_idx(path):
    """An idx file (MNIST's format), gzipped or not, as a numpy array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    dtype_code, ndim = data[2], data[3]
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    dt = {8: _np.uint8, 9: _np.int8, 11: _np.int16, 12: _np.int32,
          13: _np.float32, 14: _np.float64}[dtype_code]
    arr = _np.frombuffer(data, _np.dtype(dt).newbyteorder(">"),
                         offset=4 + 4 * ndim)
    return arr.astype(dt).reshape(dims)


class _Wrapped(DataIter):
    """An iterator that serves an inner ``NDArrayIter``."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(_Wrapped):
    """MNIST idx-format reader over local files (parity:
    src/io/iter_mnist.cc:260): images scaled to [0, 1], the last partial
    batch discarded."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        super().__init__(batch_size)
        imgs = _read_idx(image)
        labels = _read_idx(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1],
                                imgs.shape[2])
        imgs = imgs.astype(_np.float32) / 255.0
        self._inner = NDArrayIter(imgs, labels.astype(_np.float32),
                                  batch_size=batch_size, shuffle=shuffle,
                                  last_batch_handle="discard")


class CSVIter(_Wrapped):
    """CSV reader (parity: src/io/iter_csv.cc:151)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32,
                           ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32,
                                ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[0])
        else:
            label = _np.zeros((data.shape[0],), _np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")


def _not_ported(name, what):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name}: {what} (ROADMAP.md)")
    fn.__name__ = name
    return fn


LibSVMIter = _not_ported("LibSVMIter", "sparse storage is not ported yet "
                                       "(queue item 6: scale-out and sparse)")


def ImageDetRecordIter(path_imgrec, data_shape, batch_size, **kwargs):
    """Detection record iterator (parity:
    src/io/iter_image_det_recordio.cc:582): box-aware augmenters, labels
    (B, max objects, object width) padded with -1; see ``detection``."""
    from .detection import ImageDetRecordIter as _impl
    return _impl(path_imgrec=path_imgrec, data_shape=data_shape,
                 batch_size=batch_size, **kwargs)


def ImageRecordIter(path_imgrec, data_shape, batch_size, label_width=1,
                    shuffle=False, mean_r=0., mean_g=0., mean_b=0., std_r=1.,
                    std_g=1., std_b=1., rand_crop=False, rand_mirror=False,
                    preprocess_threads=4, prefetch_buffer=4,
                    device_augment=False, device_dtype="float32", ctx=None,
                    **kwargs):
    """Image record iterator (parity: src/io/iter_image_recordio_2.cc):
    decodes a ``.rec``'s payloads and yields augmented NCHW batches, read
    ahead by ``prefetch_buffer`` batches in a thread.

    With ``device_augment`` the host decodes and crops only and uploads
    one uint8 NHWC batch; the mirror, the cast, mean/std and the transpose
    run on the device, whose output dtype is ``device_dtype`` (e.g.
    ``"bfloat16"`` for a bf16 training step)."""
    from .image import ImageRecordIterPy
    it = ImageRecordIterPy(path_imgrec=path_imgrec,
                           data_shape=tuple(data_shape),
                           batch_size=batch_size, label_width=label_width,
                           shuffle=shuffle, mean=(mean_r, mean_g, mean_b),
                           std=(std_r, std_g, std_b), rand_crop=rand_crop,
                           rand_mirror=rand_mirror,
                           preprocess_threads=preprocess_threads, ctx=ctx,
                           **kwargs)
    if device_augment:
        it._device_augment = True
        it._device_dtype = device_dtype
        it.provide_data = [DataDesc(d.name, d.shape, np_dtype(device_dtype))
                           for d in it.provide_data]
    return PrefetchingIter(it, depth=int(prefetch_buffer))


class TensorRecordIter(DataIter):
    """Batches of raw-tensor records from the native loader.

    The runtime's loader thread (``src/runtime/prefetch.cc``, parity
    src/io/iter_prefetcher.h and iter_batchloader.h) reads IRHeader
    records whose payloads are ``data_shape`` values of ``dtype`` (as
    ``save_tensor_rec`` writes them), assembles ``prefetch_buffer``
    batches ahead into pooled host buffers off the GIL, and shuffles under
    ``seed`` (and the epoch).  Each batch is copied to the iterator's
    context; a last partial batch is padded from its own start with
    ``round_batch`` (``pad`` says how many), else returned short."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, seed=0, prefetch_buffer=2, dtype="uint8",
                 data_name="data", label_name="softmax_label",
                 round_batch=True, ctx=None):
        super().__init__(batch_size)
        from . import _native
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.dtype = _np.dtype(dtype)
        self.data_name = data_name
        self.label_name = label_name
        self.round_batch = round_batch
        self._device = as_device(ctx)
        self._sample_nbytes = int(_np.prod(self.data_shape)) * \
            self.dtype.itemsize
        if not os.path.isfile(path_imgrec):
            raise MXNetError(f"record file not found: {path_imgrec}")
        self._h = None
        self._lib = _native.lib()
        self._h = self._lib.MXTBatchLoaderCreate(
            path_imgrec.encode(), batch_size, self._sample_nbytes,
            label_width, int(prefetch_buffer), int(bool(shuffle)), int(seed))
        if self._h is None:
            raise MXNetError("native batch loader failed on %s: %s" % (
                path_imgrec, self._lib.MXTGetLastError().decode()))

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,) + self.data_shape,
                         self.dtype)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shp, _np.float32)]

    def reset(self):
        self._lib.MXTBatchLoaderReset(self._h)

    def _wrap(self, data_np, label_np, n):
        """A DataBatch of ``n`` rows, padded by repeating its rows from the
        start under ``round_batch``.  The arrays may be views of the
        loader's buffer, which its next call reuses: the tensors are
        copies (a synchronous copy to the card, or a clone on the CPU)."""
        pad = self.batch_size - n
        label_np = label_np.reshape(n, -1)
        if pad and self.round_batch:
            reps = -(-self.batch_size // n)
            data_np = _np.concatenate([data_np] * reps)[:self.batch_size]
            label_np = _np.concatenate([label_np] * reps)[:self.batch_size]
        if self.label_width == 1:
            label_np = label_np.reshape(-1)

        def own(a):
            t = _from_numpy(a)
            return t.clone() if self._device.type == "cpu" \
                else t.to(self._device)

        return DataBatch(
            data=[own(data_np)], label=[own(label_np)],
            pad=pad if self.round_batch else 0, index=None,
            provide_data=self.provide_data, provide_label=self.provide_label)

    def next(self):
        data_p, label_p = ctypes.c_void_p(), ctypes.c_void_p()
        n = self._lib.MXTBatchLoaderNext(self._h, data_p, label_p)
        if n < 0:
            raise MXNetError("native batch loader: %s" %
                             self._lib.MXTGetLastError().decode())
        if n == 0:
            raise StopIteration
        per = int(_np.prod(self.data_shape))
        raw = (ctypes.c_uint8 * (n * self._sample_nbytes)).from_address(
            data_p.value)
        data_np = _np.frombuffer(raw, self.dtype, count=n * per).reshape(
            (n,) + self.data_shape)
        lw = max(self.label_width, 1)
        lraw = (ctypes.c_float * (n * lw)).from_address(label_p.value)
        return self._wrap(data_np, _np.frombuffer(lraw, _np.float32), n)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.MXTBatchLoaderFree(self._h)
            self._h = None


def save_tensor_rec(path, data, labels):
    """Write arrays as raw-tensor records for ``TensorRecordIter``."""
    from .recordio import IRHeader, MXRecordIO, pack
    w = MXRecordIO(path, "w")
    for i, (x, y) in enumerate(zip(data, labels)):
        y = _np.atleast_1d(_np.asarray(y, _np.float32))
        label = y if y.size > 1 else float(y[0])
        w.write(pack(IRHeader(0, label, i, 0),
                     _np.ascontiguousarray(x).tobytes()))
    w.close()


MXDataIter = DataIter
