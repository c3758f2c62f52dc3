"""Model checkpoints, ``BatchEndParam``, the kvstore choice and the legacy
``FeedForward`` API (parity: python/mxnet/model.py).

The counterpart of ``mxnet_tpu/model.py``.  A checkpoint is
``prefix-symbol.json`` (the graph JSON) and ``prefix-%04d.params`` (an
``nd.save`` file with ``arg:``/``aux:`` keys), so either package reads the
files the other writes.  ``load_checkpoint`` reads the arrays into host
(CPU) tensors: binding copies them onto the executor's device.

Not ported: the reference-era binary ``.params`` container
(``reference_format=True``; ROADMAP.md, queue item 6).
"""
from __future__ import annotations

from collections import namedtuple
from typing import Dict

from .base import MXNetError
from .context import cpu, current_context
from . import ndarray as nd
from . import symbol as sym

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params: Dict,
                    aux_params: Dict, reference_format: bool = False) -> None:
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``; each file
    is written beside its name and moved over it, so a crash never leaves
    a torn checkpoint."""
    if reference_format:
        raise NotImplementedError(
            "save_checkpoint(reference_format=True): the reference-era "
            "binary .params format is not ported yet (ROADMAP.md, queue "
            "item 6: sparse storage and the reference-era format)")
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_checkpoint(prefix: str, epoch: int):
    """(symbol, arg_params, aux_params), the arrays as CPU tensors."""
    symbol = sym.load(f"{prefix}-symbol.json")
    save_dict = nd.load(f"{prefix}-{epoch:04d}.params", ctx=cpu())
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def _create_kvstore(kvstore, num_device: int, arg_params):
    """(kvstore or None, update_on_kvstore), by the reference's rules
    (model.py:_create_kvstore): on one device a name without "dist" or
    "tpu" gives no store; "local" updates on the store unless a parameter
    exceeds 16 Mi elements."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore and "tpu" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(arg.numel() for arg in arg_params.values()) \
                    if arg_params else 0
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise MXNetError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


class FeedForward:
    """The legacy v0.x model API, delegating to ``mx.mod.Module`` (parity:
    model.py FeedForward): numpy arrays or a DataIter in, ``fit``,
    ``predict``, ``score``, checkpoints and the one-call ``create``.  It
    runs on ``ctx``, by default the current context."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        from . import initializer as _init
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or _init.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.optimizer_params = kwargs
        self._mod = None

    def _as_iter(self, X, y=None, is_train=False):
        from . import io as _io
        import numpy as _np
        if isinstance(X, _io.DataIter):
            return X
        X = _np.asarray(X)
        if y is None and is_train:
            raise MXNetError("y is required when X is a numpy array")
        y = _np.zeros(X.shape[0]) if y is None else _np.asarray(y)
        return _io.NDArrayIter(X, y, batch_size=min(self.numpy_batch_size,
                                                    X.shape[0]),
                               shuffle=is_train)

    def _init_module(self, it):
        from . import module as _mod
        self._mod = _mod.Module(
            self.symbol,
            data_names=[d.name for d in it.provide_data],
            label_names=[l.name for l in it.provide_label],
            context=self.ctx or current_context())
        self._mod.bind(data_shapes=it.provide_data,
                       label_shapes=it.provide_label, for_training=True)
        self._mod.init_params(self.initializer,
                              arg_params=self.arg_params,
                              aux_params=self.aux_params,
                              allow_missing=self.arg_params is not None,
                              allow_extra=self.allow_extra_params)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, monitor=None):
        from . import metric as _metric
        it = self._as_iter(X, y, is_train=True)
        if self._mod is None:
            self._init_module(it)
        if self.epoch_size is not None:
            from .io import ResizeIter
            it = ResizeIter(it, self.epoch_size, reset_internal=False)
        if logger is not None:
            logger.info("Start training with %s",
                        self.ctx if self.ctx is not None
                        else current_context())
        if isinstance(eval_metric, str):
            eval_metric = _metric.create(eval_metric)
        self._mod.fit(it, eval_data=eval_data, eval_metric=eval_metric,
                      kvstore=kvstore, optimizer=self.optimizer,
                      optimizer_params=self.optimizer_params,
                      begin_epoch=self.begin_epoch,
                      num_epoch=self.num_epoch or 1,
                      epoch_end_callback=epoch_end_callback,
                      batch_end_callback=batch_end_callback,
                      monitor=monitor)
        self.arg_params, self.aux_params = self._mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        import numpy as _np
        it = self._as_iter(X)
        if self._mod is None:
            self._init_module(it)
        if reset:
            it.reset()
        outs, datas, labels = [], [], []
        for i, batch in enumerate(it):
            if num_batch is not None and i >= num_batch:
                break
            self._mod.forward(batch, is_train=False)
            n = batch.data[0].shape[0] - (batch.pad or 0)
            outs.append(nd.asnumpy(self._mod.get_outputs()[0])[:n])
            if return_data:
                datas.append(nd.asnumpy(batch.data[0])[:n])
                labels.append(nd.asnumpy(batch.label[0])[:n])
        out = _np.concatenate(outs)
        if return_data:
            return out, _np.concatenate(datas), _np.concatenate(labels)
        return out

    def score(self, X, eval_metric="acc", num_batch=None, reset=True):
        from . import metric as _metric
        it = self._as_iter(X)
        if self._mod is None:
            self._init_module(it)
        if reset:
            it.reset()
        if isinstance(eval_metric, str):
            eval_metric = _metric.create(eval_metric)
        self._mod.score(it, eval_metric, num_batch=num_batch)
        return eval_metric.get()[1]

    def save(self, prefix, epoch=None):
        epoch = self.num_epoch if epoch is None else epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer="sgd", initializer=None,
               eval_data=None, eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               **kwargs):
        """Build and fit in one call (parity: FeedForward.create)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback,
                  kvstore=kvstore, logger=logger)
        return model
