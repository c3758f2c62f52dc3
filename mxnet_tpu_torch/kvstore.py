"""KVStore: the key-value parameter store, in one process (parity:
python/mxnet/kvstore.py, src/kvstore/kvstore_local.h).

The counterpart of ``mxnet_tpu/kvstore.py`` with one worker: ``push`` sums
the values given for a key (its per-device copies) and either applies the
optimizer to the stored weight (``set_optimizer``: update on the store) or
stores the sum; ``pull`` copies the stored value into the outputs, in
place.  ``nccl`` and ``tpu_sync`` on one device reduce over that device
alone, as the JAX store does when it has one worker, so no collective
runs.  ``rank`` is 0 and ``num_workers`` 1.  A push over a list of keys
makes one ``FusedUpdater.update_all`` call; ``save_optimizer_states`` /
``load_optimizer_states`` write and read the updater's states in the JAX
package's format.

Gradient compression (``set_gradient_compression({"type": "2bit",
"threshold": t})``, parity: src/kvstore/gradient_compression.h:37-134): a
pushed value plus its key's residual is quantized to +t, -t or 0, four
2-bit codes packed per uint8 as the JAX package packs them, and the
quantization error stays in the residual for the next push.  On one
worker there is no wire to cross, but the quantize-dequantize round trip
still runs, so training follows the trajectory a pod would.  The Trainer's
fused path reduces flat gradient buckets (``GradBucketer``) through
``allreduce(buckets, compression=, residuals=)``, one flat residual per
bucket; the whole-step program runs the same ops
(``reduce_buckets_inline``).  The JAX package leaves these to XLA; here
they are torch ops.

Not ported, and raising ``NotImplementedError`` that names the queue item
(ROADMAP.md): the ``dist_*`` types and ``row_sparse_pull`` (item 6).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as _np
import torch

from . import optimizer as opt
from .base import MXNetError
from .faultinject import fire as _fi_fire
from .observability import memory as _memory
from .ndarray.ndarray import write_atomic

_TYPES = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
          "nccl", "tpu_sync", "dist", "dist_sync", "dist_async",
          "dist_device_sync", "dist_sync_device")


# -- 2-bit gradient compression -----------------------------------------------
def quantize_2bit(arr: torch.Tensor, residual: torch.Tensor,
                  threshold: float):
    """``(packed uint8 codes, new residual)`` of the flat ``arr`` against
    its float32 ``residual`` (parity: ``mxnet_tpu/kvstore.py:
    _quantize_2bit_impl``): ``r = arr + residual``; ``r >= t`` gives +t
    (code 1), ``r <= -t`` gives -t (code 2), the rest 0 (code 0); the
    residual keeps ``r`` minus that; four codes per byte, the first in the
    low bits."""
    r = arr.reshape(-1).to(torch.float32) + residual
    pos = r >= threshold
    neg = r <= -threshold
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    out = torch.where(pos, zero + threshold,
                      torch.where(neg, zero - threshold, zero))
    codes = torch.where(pos, 1, torch.where(neg, 2, 0)).to(torch.uint8)
    pad = (-codes.numel()) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    codes = codes.reshape(-1, 4)
    packed = codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4) \
        | (codes[:, 3] << 6)
    return packed, r - out


def dequantize_2bit(packed: torch.Tensor, threshold: float,
                    size: int) -> torch.Tensor:
    """The ``size`` float32 values of ``packed`` codes (parity:
    ``_dequantize_2bit_impl``)."""
    codes = torch.stack([packed & 3, (packed >> 2) & 3, (packed >> 4) & 3,
                         (packed >> 6) & 3], dim=1).reshape(-1)[:size]
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    return torch.where(codes == 1, zero + threshold,
                       torch.where(codes == 2, zero - threshold, zero))


def reduce_buckets_inline(flats, residuals, threshold):
    """The one-worker compressed reduce of flat buckets: quantize, update
    the residual, dequantize (parity: ``mxnet_tpu/kvstore.py:
    reduce_buckets_inline``, whose per-bucket mean |error|, read only by
    its metrics, is left out).  Returns (reduced buckets in their dtype,
    new residuals)."""
    outs, new_res = [], []
    for f, r in zip(flats, residuals):
        packed, nr = quantize_2bit(f, r, threshold)
        outs.append(dequantize_2bit(packed, threshold, f.numel())
                    .reshape(f.shape).to(f.dtype))
        new_res.append(nr)
    return outs, new_res


class GradientCompression:
    """The compression type and threshold (parity:
    src/kvstore/gradient_compression.h:37)."""

    def __init__(self, type="2bit", threshold=0.5):
        if type != "2bit":
            raise MXNetError("Unknown type for gradient compression " + type)
        if threshold <= 0:
            raise MXNetError("threshold must be greater than 0")
        self.type = type
        self.threshold = float(threshold)

    def quantize(self, grad: torch.Tensor, residual: torch.Tensor):
        """``(packed uint8 codes, new residual)``."""
        return quantize_2bit(grad, residual, self.threshold)

    def dequantize(self, packed: torch.Tensor, shape) -> torch.Tensor:
        return dequantize_2bit(packed, self.threshold,
                               int(_np.prod(shape))).reshape(tuple(shape))

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}


class GradBucketer:
    """Dense gradients grouped into flat buckets (parity:
    ``mxnet_tpu/kvstore.py:GradBucketer``): in input order, a new bucket at
    each change of dtype or where the next gradient would take the bucket
    past ``cap_bytes`` (``MXNET_BUCKET_SIZE_MB``).  ``views[pos]`` is
    ``(bucket, offset, shape)``; ``sizes`` the elements per bucket, which
    size the compression residuals."""

    def __init__(self, sig, cap_bytes: int):
        self.sig = tuple((tuple(s), str(d)) for s, d in sig)
        self.cap = max(1, int(cap_bytes))
        layout: List[tuple] = []
        cur: List[int] = []
        cur_dtype, cur_bytes = None, 0
        for pos, (shape, dtype) in enumerate(self.sig):
            nbytes = _dtype_size(dtype) * int(_np.prod(shape))
            if cur and (dtype != cur_dtype or cur_bytes + nbytes > self.cap):
                layout.append(tuple(cur))
                cur, cur_bytes = [], 0
            cur.append(pos)
            cur_dtype, cur_bytes = dtype, cur_bytes + nbytes
        if cur:
            layout.append(tuple(cur))
        self.layout = tuple(layout)
        self.views: List[tuple] = [None] * len(self.sig)
        sizes = []
        for b, bucket in enumerate(self.layout):
            off = 0
            for pos in bucket:
                shape = self.sig[pos][0]
                self.views[pos] = (b, off, shape)
                off += int(_np.prod(shape))
            sizes.append(off)
        self.sizes = tuple(sizes)

    def flatten(self, grads) -> List[torch.Tensor]:
        """The gradients (in ``sig`` order) as flat buckets, one copy."""
        return [torch.cat([grads[p].reshape(-1) for p in bucket])
                if len(bucket) > 1 else grads[bucket[0]].reshape(-1)
                for bucket in self.layout]

    def unflatten(self, flats) -> List[torch.Tensor]:
        """Per-gradient views into the flat buckets."""
        return [flats[b][off:off + int(_np.prod(shape))].reshape(shape)
                for b, off, shape in self.views]


def _dtype_size(dtype: str) -> int:
    """Bytes per element of a dtype named as torch names it ("bfloat16")."""
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def _key_list(key):
    if isinstance(key, (int, str)):
        return [key], False
    return list(key), True


def _val_list(value, n_keys, is_list):
    """Per key, the list of its values (one per device copy)."""
    if not is_list:
        return [list(value) if isinstance(value, (list, tuple)) else [value]]
    if len(value) != n_keys:
        raise MXNetError(f"{n_keys} keys but {len(value)} values")
    return [list(v) if isinstance(v, (list, tuple)) else [v] for v in value]


def _updater_key(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


class KVStore:
    def __init__(self, kv_type: str = "local"):
        self.type = kv_type
        self._store: Dict = {}
        self._updater = None
        self._optimizer = None
        self._compression_params = None
        self._gc: Optional[GradientCompression] = None
        self._residuals: Dict = {}

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def init(self, key, value) -> None:
        """Store a copy of each key's (first) value."""
        keys, is_list = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys), is_list)):
            self._store[k] = vlist[0].detach().clone()
            if _memory.ENABLED:
                _memory.register(self._store[k], tag="kvstore")

    def push(self, key, value, priority: int = 0) -> None:
        """Sum each key's values; update the stored weight with the sum when
        an optimizer is set, else store the sum (parity:
        kvstore_local.h:191, assign, not accumulate)."""
        keys, is_list = _key_list(key)
        merged = []
        for k, vlist in zip(keys, _val_list(value, len(keys), is_list)):
            if k not in self._store:
                raise MXNetError(f"key {k} has not been inited")
            m = vlist[0]
            for v in vlist[1:]:
                m = m + v.to(m.device)
            if self._gc is not None:
                m = self._compress(k, m)
            merged.append(m)
        if isinstance(self._updater, opt.FusedUpdater):
            self._updater.update_all([_updater_key(k) for k in keys], merged,
                                     [self._store[k] for k in keys])
        elif self._updater is not None:
            for k, m in zip(keys, merged):
                self._updater(_updater_key(k), m, self._store[k])
        else:
            for k, m in zip(keys, merged):
                self._store[k] = m.detach().clone()

    def pull(self, key, out=None, priority: int = 0) -> None:
        """Copy each key's stored value into its outputs, in place."""
        keys, is_list = _key_list(key)
        with torch.no_grad():
            for k, olist in zip(keys, _val_list(out, len(keys), is_list)):
                if k not in self._store:
                    raise MXNetError(f"key {k} not initialized")
                src = self._store[k]
                for o in olist:
                    if o is not src:
                        o.copy_(src)

    def pushpull(self, key, value, out=None, priority: int = 0) -> None:
        """``push`` then, when ``out`` is given, ``pull`` into it."""
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError(
            "KVStore.row_sparse_pull: sparse storage is not ported yet "
            "(ROADMAP.md, queue item 6: scale-out and sparse)")

    def set_optimizer(self, optimizer: "opt.Optimizer") -> None:
        """Run ``optimizer`` on every push (update on the store)."""
        self._optimizer = optimizer
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater) -> None:
        self._updater = updater

    def allreduce(self, values, compression=None, residuals=None):
        """Sum each value over its per-device copies, storing nothing: the
        Trainer's transient gradient buckets (parity:
        ``mxnet_tpu/kvstore.py:KVStore.allreduce``).  ``values`` holds one
        entry per value, a tensor or the list of its copies.  With
        ``compression`` (a ``GradientCompression`` or its params) each sum
        is quantized against its entry of ``residuals`` (flat float32, the
        caller's, zeros when None) and dequantized, and the call returns
        ``(reduced, new residuals)``.  The ``kvstore.allreduce`` fault
        site fires first."""
        _fi_fire("kvstore.allreduce")
        vals = [list(v) if isinstance(v, (list, tuple)) else [v]
                for v in values]
        merged = []
        for vl in vals:
            m = vl[0]
            for v in vl[1:]:
                m = m + v.to(m.device)
            merged.append(m)
        if compression is None:
            return merged
        if not isinstance(compression, GradientCompression):
            compression = GradientCompression(**compression)
        if residuals is None:
            residuals = [torch.zeros(m.numel(), dtype=torch.float32,
                                     device=m.device) for m in merged]
        with torch.no_grad():
            return reduce_buckets_inline(merged, residuals,
                                         compression.threshold)

    def set_gradient_compression(self, compression_params) -> None:
        """Compress every push with 2-bit quantization and error feedback
        (parity: python/mxnet/kvstore.py:363); as in the JAX package, the
        ``device``, ``dist``, ``tpu_sync`` and ``nccl`` stores take it and
        ``local`` refuses it."""
        if "type" not in compression_params:
            raise MXNetError("compression_params requires 'type'")
        if not ("device" in self.type or "dist" in self.type
                or self.type.startswith(("tpu", "nccl"))):
            raise MXNetError(
                "gradient compression is not supported on kvstore type "
                f"'{self.type}' (supported: device/dist/tpu_sync/nccl)")
        try:
            self._gc = GradientCompression(**compression_params)
        except TypeError as e:
            raise MXNetError(f"invalid compression_params: {e}") from None
        self._compression_params = self._gc.get_params()
        self._residuals = {}

    def _compress(self, k, v: torch.Tensor) -> torch.Tensor:
        """``v`` through the quantizer against key ``k``'s residual."""
        res = self._residuals.get(k)
        if res is None:
            res = torch.zeros(v.numel(), dtype=torch.float32,
                              device=v.device)
        with torch.no_grad():
            packed, self._residuals[k] = self._gc.quantize(v, res)
            return self._gc.dequantize(packed, v.shape).to(v.dtype)

    def barrier(self) -> None:
        """One worker: nothing to wait for."""

    def _barrier(self):
        self.barrier()

    def num_dead_node(self, node_id: int = 0, timeout_sec: int = 60) -> int:
        return 0

    def save_optimizer_states(self, fname: str, dump_optimizer=False):
        """Write the updater's states (and the optimizer, with
        ``dump_optimizer``) to ``fname`` atomically
        (``nd.write_atomic``)."""
        if self._updater is None:
            raise MXNetError("no optimizer set")
        write_atomic(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname: str):
        if self._updater is None:
            raise MXNetError("no optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer


def create(name: str = "local") -> KVStore:
    """A one-process store (parity: kvstore.cc:38 KVStore::Create); the
    ``dist_*`` types raise."""
    if not isinstance(name, str) or name not in _TYPES:
        raise MXNetError(f"unknown kvstore type {name}; known: {_TYPES}")
    if name.startswith("dist"):
        raise NotImplementedError(
            f"kvstore {name!r}: distributed kvstores are not ported yet "
            "(ROADMAP.md, queue item 6: scale-out)")
    return KVStore(name)
