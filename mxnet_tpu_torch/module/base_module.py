"""BaseModule: the high-level train/predict interface (parity:
python/mxnet/module/base_module.py: fit :376-487, score, predict, the
forward/backward contract, parameter get/set).

The counterpart of ``mxnet_tpu/module/base_module.py``; ``fit``'s
``checkpoint_dir`` resumes from and saves into a ``checkpoint``
directory, and ``supervise=True`` runs each step through
``gluon.TrainingSupervisor.for_module`` (transient faults retried from a
snapshot restored in place, the stall watchdog).  Each step is a
``step_span`` (a flight-recorder ``train_step`` record), each batch read
a ``data_wait`` phase and a ``mxnet_data_wait_seconds`` sample unless the
iterator times its own wait (``PrefetchingIter``).
"""
from __future__ import annotations

import logging
import time

import torch

from .. import checkpoint as _ckpt
from .. import metric as _metric
from .. import ndarray as nd
from ..context import cpu
from ..model import BatchEndParam
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability.tracing import step_span, trace_span


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name not in args:
            msg = f"You created Module with Module(..., {typename}_names=" \
                  f"{names}) but input with name '{name}' is not found in " \
                  "symbol.list_arguments()."
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high-level ----------------------------------------------------------
    def forward_backward(self, data_batch) -> None:
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Run ``eval_metric`` over ``eval_data`` in inference mode;
        returns its (name, value) pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs without the padded rows, nbatch, batch)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data`` without the padded rows, each
        output's batches concatenated (``merge_batches``)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad].clone()
                                for out in self.get_outputs()])
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise ValueError("Cannot merge batches: different number "
                                     "of outputs")
            output_list2 = [torch.cat([out[i] for out in output_list])
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint_dir=None, checkpoint_period=1,
            checkpoint_max_keep=None, supervise=False):
        """Train loop (parity: base_module.py:376-487): bind, initialize
        (an already initialized module keeps its parameters and optimizer),
        then per epoch forward_backward, update and the metric per batch,
        the callbacks, and ``score`` on ``eval_data``.

        ``checkpoint_dir`` resumes from the newest valid checkpoint there
        (parameters, aux states and optimizer states; ``begin_epoch``
        advances to the saved epoch), saves one atomic async checkpoint
        every ``checkpoint_period`` epochs and after the last, keeps the
        newest ``checkpoint_max_keep`` (None = all), and waits for the
        writes before returning.

        ``supervise=True`` runs each step (forward_backward + update)
        through ``TrainingSupervisor.for_module``: transient failures retry
        from a rolling snapshot restored in place, the stall watchdog
        raises typed errors.  Inert under ``MXNET_SUPERVISE=0``."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = _ckpt.CheckpointManager(checkpoint_dir,
                                           max_to_keep=checkpoint_max_keep)
            begin_epoch = max(begin_epoch, self._resume(ckpt, checkpoint_dir))
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        sup = None
        if supervise:
            from ..gluon.supervisor import TrainingSupervisor
            sup = TrainingSupervisor.for_module(self)
        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             validation_metric, epoch_end_callback,
                             batch_end_callback, eval_end_callback,
                             eval_batch_end_callback, monitor, begin_epoch,
                             num_epoch, ckpt, checkpoint_period, sup)
        finally:
            if sup is not None:
                sup.close()
            if ckpt is not None:
                ckpt.close()  # every queued write committed, or raised

    def _resume(self, ckpt, checkpoint_dir) -> int:
        """Load the newest valid checkpoint under ``ckpt``; its epoch, or
        0 when there is none."""
        restored = ckpt.restore()
        if restored is None:
            return 0
        epoch, state = restored
        args, auxs, opt_states, _ = _ckpt.unpack_module_state(state)
        self.set_params({k: nd.array(v, ctx=cpu()) for k, v in args.items()},
                        {k: nd.array(v, ctx=cpu()) for k, v in auxs.items()})
        if opt_states is not None:
            if hasattr(self, "set_optimizer_states_bytes"):
                self.set_optimizer_states_bytes(opt_states)
            else:
                self.logger.warning(
                    "checkpoint carries optimizer state but %s cannot "
                    "restore it; resuming params only", type(self).__name__)
        self.logger.info("fit: resumed from checkpoint epoch %d in %s",
                         epoch, checkpoint_dir)
        return int(epoch)

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, monitor, begin_epoch,
                    num_epoch, ckpt=None, checkpoint_period=1, sup=None):
        global_step = 0
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            with trace_span("data_fetch", cat="io"), \
                    _flight.phase_span("data_wait", cat="io"):
                next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                if monitor is not None:
                    monitor.tic()
                d0 = _metrics.step_dispatches()
                with step_span(global_step):
                    if sup is not None:
                        sup.step(data_batch)
                    else:
                        self.forward_backward(data_batch)
                        with trace_span("update", cat="optimizer"):
                            self.update()
                if _metrics.ENABLED:
                    _metrics.FIT_STEP_DISPATCHES.set(
                        _metrics.step_dispatches() - d0)
                global_step += 1
                # iterators that time their own wait (PrefetchingIter)
                # are not counted again here
                timed = _metrics.ENABLED and not getattr(
                    data_iter, "_self_timed_data_wait", False)
                t0 = time.perf_counter() if timed else 0.0
                try:
                    with trace_span("data_fetch", cat="io"), \
                            _flight.phase_span("data_wait", cat="io",
                                               step=global_step):
                        next_data_batch = next(data_iter)
                    self.prepare(next_data_batch)
                except StopIteration:
                    end_of_batch = True
                if timed:
                    _metrics.DATA_WAIT_SECONDS.observe(
                        time.perf_counter() - t0)
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    batch_end_params = BatchEndParam(
                        epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                        locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(batch_end_params)
                nbatch += 1

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, (toc - tic))

            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if ckpt is not None and (
                    (epoch + 1) % max(1, checkpoint_period) == 0
                    or epoch == num_epoch - 1):   # the last epoch is saved
                # the host copy happens here, the write off the loop
                opt_bytes = self.get_optimizer_states_bytes() \
                    if hasattr(self, "get_optimizer_states_bytes") else None
                ckpt.save(epoch + 1, _ckpt.pack_module_state(
                    self.symbol, arg_params_, aux_params_,
                    optimizer_states=opt_bytes))
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def _adopt_existing_bind(self, data_shapes, label_shapes, for_training,
                             inputs_need_grad=False, grad_req="write",
                             against=None):
        """A re-bind that matches the current one (data/label names,
        shapes and dtypes, training mode, inputs_need_grad, grad_req) is a
        no-op; one that conflicts raises (use ``force_rebind=True``).
        ``against`` is the module whose bind is compared (a
        ``BucketingModule`` compares its default bucket's)."""
        from ..base import np_dtype
        from ..io import DataDesc

        def norm(descs):
            out = []
            for d in (descs or []):
                d = d if isinstance(d, DataDesc) else DataDesc(*d)
                out.append((d.name, tuple(d.shape), np_dtype(d.dtype).name))
            return out

        req = (norm(data_shapes), norm(label_shapes), bool(for_training),
               bool(inputs_need_grad), grad_req)
        ref = against if against is not None else self
        cur = (norm(ref.data_shapes), norm(ref.label_shapes),
               bool(ref.for_training), bool(ref.inputs_need_grad),
               getattr(ref, "_grad_req", grad_req))
        if req != cur:
            raise ValueError(
                "Module is already bound with (data, label, for_training, "
                "inputs_need_grad, grad_req)=%s; bind(%s) conflicts. "
                "Use force_rebind=True." % (cur, req))

    # -- interface to implement ----------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """Write the parameters to one ``nd.save`` file, ``arg:``/``aux:``
        keys."""
        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        """Read a ``save_params`` file (through host tensors) and set the
        parameters."""
        save_dict = nd.load(fname, ctx=cpu())
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, _, name = k.partition(":")
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError(f"Invalid param file {fname}")
        self.set_params(arg_params, aux_params)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized

    def install_monitor(self, mon):
        raise NotImplementedError

    def prepare(self, data_batch):
        pass

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError
