"""Training-loop callbacks (parity: python/mxnet/callback.py).

The counterpart of ``mxnet_tpu/callback.py``: the epoch-end checkpointers
(``do_checkpoint``, ``module_checkpoint``) and the batch-end loggers
(``Speedometer``, ``ProgressBar``, ``log_train_metric``,
``LogValidationMetricsCallback``).  Batch-end callbacks receive a
``BatchEndParam`` (``epoch``, ``nbatch``, ``eval_metric``); epoch-end
callbacks are called as ``cb(epoch, symbol, arg_params, aux_params)``.
With ``MXNET_CHECKPOINT_DIR`` set (read at each call), the checkpointers
save through ``checkpoint.env_manager()``'s atomic manager, the epoch
number as the step, as the JAX package's do.

Not ported: ``do_checkpoint(reference_format=True)``, the reference-era
binary container (item 6).
"""
from __future__ import annotations

import logging
import time


def _emit(fmt, *values):
    logging.info(fmt, *values)


def _due(counter: int, period: int) -> bool:
    """True on every ``period``-th 1-indexed tick."""
    return period > 0 and counter % period == 0


def _metric_pairs(param):
    m = getattr(param, "eval_metric", None)
    return m.get_name_value() if m else []


def _checkpointer(save_fn, period, managed_fn):
    """Every ``period`` epochs: ``managed_fn(manager, n, ...)`` when
    ``MXNET_CHECKPOINT_DIR`` names a managed directory, else
    ``save_fn(n, ...)``'s prefix files."""
    period = max(1, int(period))

    def on_epoch_end(epoch, sym=None, arg=None, aux=None):
        if not _due(epoch + 1, period):
            return
        from .checkpoint import env_manager
        mgr = env_manager()
        if mgr is not None:
            managed_fn(mgr, epoch + 1, sym, arg, aux)
        else:
            save_fn(epoch + 1, sym, arg, aux)

    return on_epoch_end


def do_checkpoint(prefix, period=1, reference_format=False):
    """Save the symbol and parameters to ``prefix``-NNNN.params every
    ``period`` epochs (with ``MXNET_CHECKPOINT_DIR``, to the manager)."""
    from .model import save_checkpoint
    if reference_format:
        raise NotImplementedError(
            "do_checkpoint(reference_format=True): the reference-era binary "
            ".params format is not ported yet (ROADMAP.md, queue item 6)")

    def _managed(mgr, n, sym, arg, aux):
        from .checkpoint import pack_module_state
        mgr.save(n, pack_module_state(sym, arg or {}, aux or {}),
                 meta={"prefix": prefix, "source": "do_checkpoint"})

    return _checkpointer(
        lambda n, sym, arg, aux: save_checkpoint(prefix, n, sym, arg, aux),
        period, _managed)


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Save a Module's checkpoint every ``period`` epochs (with
    ``MXNET_CHECKPOINT_DIR``, to the manager, the optimizer states in the
    same commit)."""

    def _managed(mgr, n, *_):
        from .checkpoint import pack_module_state
        arg, aux = mod.get_params()
        opt_states = mod.get_optimizer_states_bytes() \
            if save_optimizer_states and mod.optimizer_initialized else None
        mgr.save(n, pack_module_state(mod.symbol, arg, aux,
                                      optimizer_states=opt_states),
                 meta={"prefix": prefix, "source": "module_checkpoint"})

    return _checkpointer(
        lambda n, *_: mod.save_checkpoint(prefix, n, save_optimizer_states),
        period, _managed)


def log_train_metric(period, auto_reset=False):
    """Log the training metric every ``period`` batches."""

    def on_batch_end(param):
        if not _due(param.nbatch, period):
            return
        for name, value in _metric_pairs(param):
            _emit("Iter[%d] Batch[%d] Train-%s=%f",
                  param.epoch, param.nbatch, name, value)
        if auto_reset and param.eval_metric is not None:
            param.eval_metric.reset()

    return on_batch_end


class Speedometer:
    """Throughput logger: samples/sec over each ``frequent``-batch stride,
    with the current metric values appended."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._stride_start = None
        self._prev_nbatch = -1

    def __call__(self, param):
        if param.nbatch < self._prev_nbatch:
            self._stride_start = None  # new epoch: restart the stride
        self._prev_nbatch = param.nbatch
        if self._stride_start is None:
            self._stride_start = time.time()
            return
        if not _due(param.nbatch, self.frequent):
            return
        elapsed = max(time.time() - self._stride_start, 1e-12)
        rate = self.frequent * self.batch_size / elapsed
        pairs = _metric_pairs(param)
        if pairs:
            if self.auto_reset:
                param.eval_metric.reset()
            tail = "".join("\t%s=%f" % p for p in pairs)
            _emit("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                  param.epoch, param.nbatch, rate, tail)
        else:
            _emit("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                  param.epoch, param.nbatch, rate)
        self._stride_start = time.time()


class ProgressBar:
    """Fixed-width text progress bar over ``total`` batches."""

    def __init__(self, total, length=80):
        self.total = total
        self.bar_len = length

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        fill = int(round(self.bar_len * frac))
        pct = int(-(-100.0 * frac // 1))  # ceil
        _emit("[%s] %s%s\r",
              "=" * fill + "-" * (self.bar_len - fill), pct, "%")


class LogValidationMetricsCallback:
    """Epoch-end eval logger: one line per metric."""

    def __call__(self, param):
        for name, value in _metric_pairs(param):
            _emit("Epoch[%d] Validation-%s=%f", param.epoch, name, value)
