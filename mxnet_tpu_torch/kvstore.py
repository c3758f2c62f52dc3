"""KVStore: the key-value parameter store, in one process (parity:
python/mxnet/kvstore.py, src/kvstore/kvstore_local.h).

The counterpart of ``mxnet_tpu/kvstore.py`` with one worker: ``push`` sums
the values given for a key (its per-device copies) and either applies the
optimizer to the stored weight (``set_optimizer``: update on the store) or
stores the sum; ``pull`` copies the stored value into the outputs, in
place.  ``nccl`` and ``tpu_sync`` on one device reduce over that device
alone, as the JAX store does when it has one worker, so no collective
runs.  ``rank`` is 0 and ``num_workers`` 1.

Not ported, and raising ``NotImplementedError`` that names the queue item
(ROADMAP.md): the ``dist_*`` types and ``row_sparse_pull`` (item 6),
gradient compression and ``save/load_optimizer_states`` (item 4).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import optimizer as opt
from .base import MXNetError

_TYPES = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
          "nccl", "tpu_sync", "dist", "dist_sync", "dist_async",
          "dist_device_sync", "dist_sync_device")
_ITEM4 = "not ported yet (ROADMAP.md, queue item 4: the fused step and " \
         "checkpoints)"


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
        for k, vlist in zip(keys, _val_list(value, len(keys), is_list)):
            if k not in self._store:
                raise MXNetError(f"key {k} has not been inited")
            merged = vlist[0]
            for v in vlist[1:]:
                merged = merged + v.to(merged.device)
            if self._updater is not None:
                self._updater(_updater_key(k), merged, self._store[k])
            else:
                self._store[k] = merged.detach().clone()

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
        raise NotImplementedError(
            f"KVStore.save_optimizer_states: optimizer-state files are "
            f"{_ITEM4}")

    def load_optimizer_states(self, fname: str):
        raise NotImplementedError(
            f"KVStore.load_optimizer_states: optimizer-state files are "
            f"{_ITEM4}")


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
