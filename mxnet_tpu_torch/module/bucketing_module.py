"""BucketingModule: one logical model, one executor per bucket key
(parity: ``mxnet_tpu/module/bucketing_module.py``).

Every bucket is a ``Module`` over the symbol ``sym_gen(key)`` gives, bound
with the default bucket's module as ``shared_module``: the parameters (and
their gradient and aux tensors where shapes agree) are the same tensors in
every bucket, and one optimizer and updater serve them all.  Switching to
a bound bucket is a dict lookup.  The modules run on ``context`` (default
the current context, ``gpu(0)``; the JAX module defaults to the CPU), and
without CUDA a ``gpu`` context raises ``MXNetError`` at ``bind``.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        # construction kwargs replayed for every per-bucket Module
        self._module_kwargs = dict(
            logger=logger,
            context=context,
            work_load_list=work_load_list,
            fixed_param_names=fixed_param_names or [],
            state_names=state_names or [],
            group2ctxs=group2ctxs,
            compression_params=compression_params,
        )
        self._reset_bind()
        self._monitor = None
        self._grad_req = None

    # -- internal helpers ---------------------------------------------------
    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._active = None       # the Module handling the current bucket
        self._active_key = None
        self._params_dirty = False

    def _call_sym_gen(self, bucket_key):
        return self._sym_gen(bucket_key)

    @property
    def _default_module(self):
        return self._buckets[self._default_bucket_key]

    def _require(self, params=False, optimizer=False):
        if not self.binded:
            raise MXNetError("BucketingModule not bound")
        if params and not self.params_initialized:
            raise MXNetError("parameters not initialized")
        if optimizer and not self.optimizer_initialized:
            raise MXNetError("optimizer not initialized")

    def _materialize(self, bucket_key, data_shapes, label_shapes,
                     for_training, inputs_need_grad, shared):
        """Build + bind the Module for one bucket key."""
        symbol, data_names, label_names = self._call_sym_gen(bucket_key)
        mod = Module(symbol, data_names, label_names, **self._module_kwargs)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind=False, shared_module=shared,
                 grad_req=self._grad_req)
        return mod

    def _activate(self, bucket_key, data_shapes, label_shapes):
        """switch_bucket body: reuse or materialize, then make current."""
        if bucket_key not in self._buckets:
            mod = self._materialize(
                bucket_key, data_shapes, label_shapes,
                self._active.for_training, self._active.inputs_need_grad,
                shared=self._default_module)
            if self._monitor is not None:
                mod.install_monitor(self._monitor)
            if self.optimizer_initialized:
                mod.borrow_optimizer(self._default_module)
            self._buckets[bucket_key] = mod
        self._active = self._buckets[bucket_key]
        self._active_key = bucket_key

    # -- introspection ------------------------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._active.data_names
        return self._call_sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._active.output_names
        return self._call_sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._require()
        return self._active.data_shapes

    @property
    def label_shapes(self):
        self._require()
        return self._active.label_shapes

    @property
    def output_shapes(self):
        self._require()
        return self._active.output_shapes

    @property
    def symbol(self):
        self._require()
        return self._active.symbol

    # -- parameters ---------------------------------------------------------
    def get_params(self):
        self._require(params=True)
        self._active._params_dirty = self._params_dirty
        params = self._active.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._require()
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)
        self._active.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            # strict mode routes through init_params (reference behavior)
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._active.set_params(arg_params, aux_params,
                                allow_missing=allow_missing,
                                force_init=force_init,
                                allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    # -- binding / bucket switching -----------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            # compare against the DEFAULT bucket's bind state: fit() always
            # re-binds with the default-bucket shapes, and the current
            # bucket may legitimately differ after switch_bucket()
            self._adopt_existing_bind(
                data_shapes, label_shapes, for_training, inputs_need_grad,
                grad_req, against=self._default_module)
            return
        if shared_module is not None:
            raise MXNetError(
                "shared_module is not supported for BucketingModule")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        mod = self._materialize(self._default_bucket_key, data_shapes,
                                label_shapes, for_training,
                                inputs_need_grad, shared=None)
        self._buckets[self._default_bucket_key] = mod
        self._active = mod
        self._active_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        self._require()
        self._activate(bucket_key, data_shapes, label_shapes)

    def prepare(self, data_batch):
        """Pre-materialize the batch's bucket without making it current."""
        self._require(params=True)
        held, held_key = self._active, self._active_key
        self._activate(data_batch.bucket_key, data_batch.provide_data,
                       data_batch.provide_label)
        self._active, self._active_key = held, held_key

    def warmup_buckets(self, buckets, run=True, for_training=False):
        """AOT-warm a set of buckets before traffic (the serving-path
        `warmup()` idea applied to the training/eval bucketing surface):
        `buckets` is an iterable of (bucket_key, data_shapes,
        label_shapes) triples.  Each bucket is materialized (bound,
        params shared) and, with `run=True`, run once on zeros (its
        kernels loaded, its allocations made); after warmup,
        `switch_bucket` between warmed keys costs a dict lookup.

        `for_training=True` runs forward and backward instead of the
        inference forward.  The aux states are put back afterwards and
        the gradient buffers zeroed, so warmup changes nothing a later
        step reads (grad_req='add' included)."""
        self._require(params=True)
        import torch
        from .. import ndarray as nd
        from ..io import DataBatch
        if for_training and not self.for_training:
            raise MXNetError(
                "warmup_buckets(for_training=True) on a module bound "
                "with for_training=False")
        held, held_key = self._active, self._active_key
        try:
            for bucket_key, data_shapes, label_shapes in buckets:
                self._activate(bucket_key, data_shapes, label_shapes)
                if not run:
                    continue
                ctx = self._active._context[0]
                data = [nd.zeros(tuple(d.shape), ctx=ctx, dtype=getattr(
                    d, "dtype", "float32")) for d in data_shapes]
                label = [nd.zeros(tuple(d.shape), ctx=ctx, dtype=getattr(
                    d, "dtype", "float32")) for d in (label_shapes or [])]
                batch = DataBatch(data=data, label=label or None, pad=0,
                                  index=None, bucket_key=bucket_key,
                                  provide_data=data_shapes,
                                  provide_label=label_shapes)
                if for_training:
                    ex = self._active._exec
                    # a training-mode forward on the zeros batch also
                    # advances aux state (BatchNorm moving stats):
                    # snapshot and restore so warmup mutates nothing
                    aux_snap = {k: v.clone() for k, v in ex.aux_dict.items()}
                    self._active.forward_backward(batch)
                    with torch.no_grad():
                        for k, v in aux_snap.items():
                            ex.aux_dict[k].copy_(v)
                        # under grad_req='add' the warmup gradients would
                        # otherwise accumulate into the first real step
                        for g in ex.grad_dict.values():
                            if g is not None:
                                g.zero_()
                else:
                    self._active.forward(batch, is_train=False)
        finally:
            self._active, self._active_key = held, held_key

    # -- generative decode --------------------------------------------------
    def attach_decode_engine(self, engine) -> None:
        """Route this module's generation through a continuous-batching
        ``serving.decode.DecodeEngine`` (per-step join/leave, paged KV,
        EDF shedding).  The engine owns its own decode model and params:
        build one with ``serving.decode.CellModel`` over a steppable
        rnn cell to serve the cell family this module trains."""
        self._decode_engine = engine

    def generate(self, prompt, max_new_tokens, **kw):
        """Generate ``max_new_tokens`` greedy tokens after ``prompt``
        (a token-id sequence) through the attached decode engine.

        Without an attached engine this raises a typed
        ``GenerativeRouteError`` instead of falling back to per-bucket
        ``forward`` loops or the request-coalescing serving tier: either
        would pin a whole batch for one sequence's full output length."""
        from ..serving.decode import GenerativeRouteError
        eng = getattr(self, "_decode_engine", None)
        if eng is None:
            raise GenerativeRouteError(
                "BucketingModule has no decode engine attached — "
                "generation must not ride the bucketed forward path "
                "(one sequence would hold a whole padded batch for "
                "its full output length).  attach_decode_engine("
                "serving.decode.DecodeEngine(...)) first")
        return eng.generate(prompt, max_new_tokens, **kw)

    # -- compute ------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require(params=True)
        self._activate(data_batch.bucket_key, data_batch.provide_data,
                       data_batch.provide_label)
        self._active.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        self._require(params=True)
        self._activate(data_batch.bucket_key, data_batch.provide_data,
                       data_batch.provide_label)
        self._active.forward_backward(data_batch)

    def backward(self, out_grads=None):
        self._require(params=True)
        self._active.backward(out_grads=out_grads)

    def update(self):
        self._require(params=True, optimizer=True)
        self._params_dirty = True
        self._active.update()

    def get_outputs(self, merge_multi_context=True):
        self._require(params=True)
        return self._active.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(params=True)
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return self._active.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require(params=True)
        self._active.update_metric(eval_metric, labels)

    # -- optimizer / monitor ------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._active.init_optimizer(kvstore, optimizer, optimizer_params,
                                    force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._active:
                mod.borrow_optimizer(self._active)
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        self._require()
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
