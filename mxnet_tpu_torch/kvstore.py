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

Not ported, and raising ``NotImplementedError`` that names the queue item
(ROADMAP.md): the ``dist_*`` types and ``row_sparse_pull`` (item 6) and
gradient compression (item 4).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray.ndarray import write_atomic

_TYPES = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
          "nccl", "tpu_sync", "dist", "dist_sync", "dist_async",
          "dist_device_sync", "dist_sync_device")
_ITEM4 = "not ported yet (ROADMAP.md, queue item 4)"


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

    def set_gradient_compression(self, compression_params) -> None:
        raise NotImplementedError(
            f"KVStore.set_gradient_compression: gradient compression is "
            f"{_ITEM4}")

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
