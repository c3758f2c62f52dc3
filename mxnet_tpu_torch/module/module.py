"""Module: the intermediate-level training API over one executor (parity:
python/mxnet/module/module.py:39; the kvstore wiring of model.py:97-138).

The counterpart of ``mxnet_tpu/module/module.py`` on one context, by
default the current one (``gpu(0)``; the JAX module defaults to the CPU).
``bind`` infers every argument's and aux state's shape and dtype from the
data and label descriptions (bf16 data gives bf16 weights and float32
BatchNorm statistics, as in the JAX package) and allocates them, with
their gradient buffers, on that device; ``init_params`` draws the weights
in the JAX module's order, so one seed gives the same weights in both
packages.  Each batch is copied into the bound input tensors.  ``update``
goes through the kvstore (``pushpull``, update on the store) or the
``FusedUpdater``'s ``update_all``, by ``model._create_kvstore``'s rules.
``save_optimizer_states`` / ``load_optimizer_states`` (and
``save_checkpoint(save_optimizer_states=True)``, ``Module.load(...,
load_optimizer_states=True)``) write and read the JAX package's
``.states`` files.

``MXNET_FUSED_STEP=1`` makes ``forward_backward`` the whole training
step (parity: ``mxnet_tpu/module/module.py:464-610``): forward, backward
and the update through the store's updater when the store updates (else
the module's), with the hyper-parameters on the device
(``optimizer.HyperDeviceCache``), and ``update`` then does nothing.  On a
card the step is one CUDA graph (``gluon.wholestep.StepGraph``): eager the
first time, captured the second, replayed after; weights, optimizer
states, the store's copies and the aux states are written in place, the
bound inputs are its static buffers.  ``grad_dict`` is not written, and
the outputs are the graph's, rewritten by the next step.  A module it
cannot take (an optimizer without ``fused_step``, gradient compression,
a monitor, mirroring, ``inputs_need_grad``, a ``grad_req`` other than
"write") runs the standard step, with one warning.

Not ported, and raising ``NotImplementedError`` that names the queue item
(ROADMAP.md): more than one context, ``group2ctxs`` and sparse gradients
(item 6).
"""
from __future__ import annotations

import logging

import torch

from .. import optimizer as opt
from ..base import MXNetError, getenv
from ..faultinject import fire as _fi_fire
from ..observability import memory as _memory
from ..observability.tracing import trace_span
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import _create_kvstore, load_checkpoint, save_checkpoint
from ..ndarray.ndarray import write_atomic
from .base_module import BaseModule, _check_input_names

_ITEM6 = "not ported yet (ROADMAP.md, queue item 6: scale-out and sparse)"


def _desc(d):
    return d if isinstance(d, DataDesc) else DataDesc(*d)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        if len(context) > 1:
            raise NotImplementedError(
                f"Module over {len(context)} contexts: data parallelism is "
                f"{_ITEM6}")
        if group2ctxs:
            raise NotImplementedError(f"Module(group2ctxs=...): model "
                                      f"parallelism is {_ITEM6}")
        self._context = context
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) if fixed_param_names \
            is not None else []
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._compression_params = compression_params
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = "write"

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over the checkpoint's symbol, its parameters set when it
        is bound and initialized, and with ``load_optimizer_states`` the
        ``prefix-epoch.states`` file loaded by ``init_optimizer``."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        reference_format=False):
        save_checkpoint(prefix, epoch, self.symbol, *self.get_params(),
                        reference_format=reference_format)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    # -- shapes ---------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        if self._exec._outputs is not None:
            return [(n, tuple(o.shape)) for n, o in
                    zip(self._output_names, self._exec.outputs)]
        shapes = {d.name: d.shape
                  for d in self._data_shapes + self._label_shapes}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # -- params ---------------------------------------------------------------
    def get_params(self):
        """(arg_params, aux_params): copies of the bound parameters, taken
        when they have changed since the last call."""
        assert self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Initialize the parameters, ``_param_names`` first, then the aux
        states in sorted order, each by ``initializer(InitDesc(name,
        attrs), tensor)`` unless ``arg_params``/``aux_params`` give it."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        ex = self._exec
        if self._arg_params is None:
            self._arg_params = {
                name: torch.zeros_like(arr) for name, arr in
                ex.arg_dict.items() if name in self._param_names}
        if self._aux_params is None:
            self._aux_params = {name: torch.zeros_like(arr)
                                for name, arr in ex.aux_dict.items()}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                if cache[name] is not arr:
                    arr.copy_(cache[name])
            elif not allow_missing and cache is not None:
                raise RuntimeError(f"{name} is not presented")
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        with torch.no_grad():
            for name in self._param_names:
                _impl(name, self._arg_params[name], arg_params)
            for name, arr in sorted(self._aux_params.items()):
                _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        ex.copy_params_from(self._arg_params, self._aux_params,
                            allow_extra_params=True)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._exec.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=True)
        self.params_initialized = True
        self._params_dirty = True

    def _sync_params_from_devices(self):
        """Copy the bound parameters into ``_arg_params``/``_aux_params``
        (the optimizer updates the bound ones in place)."""
        with torch.no_grad():
            for name in self._param_names:
                self._arg_params[name].copy_(self._exec.arg_dict[name])
            for name, arr in self._exec.aux_dict.items():
                self._aux_params[name].copy_(arr)
        self._params_dirty = False

    # -- bind -----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Infer shapes and dtypes from ``data_shapes``/``label_shapes``
        (DataDescs or (name, shape) pairs), allocate the arguments, their
        gradient buffers and the aux states on the context, and build the
        executor.  Without CUDA a ``gpu`` context raises ``MXNetError``."""
        from ..executor import Executor
        from ..ndarray import zeros
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self._adopt_existing_bind(data_shapes, label_shapes,
                                      for_training, inputs_need_grad,
                                      grad_req)
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        assert not for_training or label_shapes is not None or \
            not self._label_names
        self._data_shapes = [_desc(d) for d in data_shapes]
        self._label_shapes = [_desc(d) for d in label_shapes] \
            if label_shapes else []
        descs = self._data_shapes + self._label_shapes
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(
            **{d.name: tuple(d.shape) for d in descs})
        arg_types, _, aux_types = self._symbol.infer_type(
            **{d.name: d.dtype for d in descs})
        ctx = self._context[0]
        shared_args = shared_module._exec.arg_dict if shared_module else {}
        shared_aux = shared_module._exec.aux_dict if shared_module else {}

        def alloc(shared, name, shp, dt):
            if name in shared and tuple(shared[name].shape) == tuple(shp):
                return shared[name]
            return zeros(shp, ctx=ctx, dtype=dt)

        args, grads, reqs = {}, {}, {}
        for name, shp, dt in zip(self._symbol.list_arguments(), arg_shapes,
                                 arg_types):
            args[name] = alloc(shared_args, name, shp, dt)
            if not for_training:
                reqs[name] = "null"
            elif name in self._data_names or name in self._label_names \
                    or name in self._state_names:
                reqs[name] = "write" if inputs_need_grad and \
                    name in self._data_names else "null"
            elif name in self._fixed_param_names:
                reqs[name] = "null"
            else:
                reqs[name] = grad_req if isinstance(grad_req, str) else \
                    grad_req.get(name, "write")
            if reqs[name] != "null":
                grads[name] = zeros(shp, ctx=ctx, dtype=dt)
        aux = {name: alloc(shared_aux, name, shp, dt) for name, shp, dt in
               zip(self._aux_names, aux_shapes, aux_types)}
        self._exec = Executor(self._symbol, ctx, args, grads, reqs, aux)
        if _memory.ENABLED:
            inputs = set(self._data_names) | set(self._label_names) | \
                set(self._state_names)
            for name, t in args.items():
                _memory.register(t, tag="executor" if name in inputs
                                 else "param")
            for t in aux.values():
                _memory.register(t, tag="param")
            for t in grads.values():
                _memory.register(t, tag="grad")
        sparse = [s.in_refs[1][1] for s in self._exec._plan.steps
                  if s.op.name == "Embedding" and s.params.get("sparse_grad")
                  and reqs.get(s.in_refs[1][1], "null") != "null"]
        if sparse:
            self._exec = None
            raise NotImplementedError(
                f"Module: row-sparse gradients of {sparse} "
                f"(Embedding(sparse_grad=True)) are {_ITEM6}")
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
        elif self.params_initialized:       # Module.load, or a rebind
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    # -- optimizer ------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer with ``rescale_grad = 1/batch`` and the graph's
        lr/wd multipliers, and the kvstore by ``_create_kvstore``: with a
        store that updates, the optimizer runs on ``pushpull``; otherwise
        the per-parameter ``Updater`` runs in ``update``."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.debug("optimizer already initialized, adopting")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context),
            {n: self._exec.arg_dict[n] for n in self._param_names})
        batch_size = self._data_shapes[0].shape[0]
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size

        idx2name = {i: n for i, n in enumerate(self._param_names)}
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    f"num_workers ({rescale_grad} vs. "
                    f"{optimizer.rescale_grad}). Is this intended?")
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            for name in self._param_names:
                kvstore.init(name, self._exec.arg_dict[name])
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # -- compute --------------------------------------------------------------
    def _set_batch(self, data_batch, is_train):
        """Copy the batch into the bound input tensors; a batch of another
        size replaces them with its own copy (a partial last batch)."""
        feeds = list(zip(self._data_names, data_batch.data))
        if is_train and data_batch.label:
            feeds += [(n, a) for n, a in zip(self._label_names,
                                             data_batch.label)
                      if n in self._exec.arg_dict]
        self._exec._load(dict(feeds))

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._set_batch(data_batch, is_train or bool(data_batch.label))
        self._exec.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """One training step's forward and backward on ``data_batch``; with
        ``MXNET_FUSED_STEP=1`` the whole step, update included."""
        assert self.binded and self.params_initialized
        # a flag left by a fused step whose update() was skipped must not
        # swallow the next standard update
        self.__dict__.pop("_fused_stepped", None)
        if self._maybe_fused_train_step(data_batch):
            return
        self._set_batch(data_batch, True)
        self._exec.forward_backward()

    # -- the one-program training step (MXNET_FUSED_STEP=1) -----------------
    def _fused_step_updater(self):
        if self._update_on_kvstore and self._kvstore is not None:
            return self._kvstore._updater
        return self._updater

    def _fused_step_eligible(self) -> bool:
        if not getenv("MXNET_FUSED_STEP", 0) or \
                not self.optimizer_initialized:
            return False
        ex = self._exec
        upd = self._fused_step_updater()
        ok = (isinstance(upd, opt.FusedUpdater)
              and getattr(upd.optimizer, "fused", False)
              and ex._monitor is None and ex._segments <= 1
              and not self.inputs_need_grad
              and getattr(self._kvstore, "_gc", None) is None
              and all(ex.grad_req.get(n, "null") in ("null", "write")
                      for n in ex.arg_dict))
        if not ok and not self.__dict__.get("_fstep_warned"):
            self.logger.warning(
                "MXNET_FUSED_STEP=1 requested but this module is not "
                "eligible (needs: fused optimizer, single device, dense "
                "write grads, no compression/monitor) — using the "
                "standard 2-program step")
            self._fstep_warned = True
        return ok

    def _maybe_fused_train_step(self, data_batch) -> bool:
        if not self._fused_step_eligible():
            return False
        from ..gluon.wholestep import StepGraph, _leaves, count_snapshot, \
            step_generators, update_groups
        from ..kvstore import _updater_key
        ex = self._exec
        upd = self._fused_step_updater()
        opt_ = upd.optimizer
        self._set_batch(data_batch, True)
        kv_key = bool(self._update_on_kvstore and self._kvstore is not None)
        live = [(i, n) for i, n in enumerate(self._param_names)
                if n in ex.grad_dict]
        names = [n for _, n in live]
        ukeys = [_updater_key(n) if kv_key else i for i, n in live]
        weights = [ex.arg_dict[n] for n in names]
        for k, w in zip(ukeys, weights):
            upd._ensure_state(k, w)
        states = [upd.states[k] for k in ukeys]
        device = weights[0].device
        store = [self._kvstore._store[n] for n in names] if kv_key else []
        graph = self.__dict__.get("_fstep_graph")
        if graph is None:
            graph = self._fstep_graph = StepGraph("MXNET_FUSED_STEP",
                                                  self._fused_where,
                                                  program="module_step")
        groups = update_groups(opt_, weights, device,
                               self.__dict__.setdefault("_fstep_groups", {}))
        rollback = count_snapshot(opt_, ukeys)
        for k in ukeys:
            opt_._update_count(k)
        try:
            hyper, counts_t = upd.hyper_cache.arrays(opt_, ukeys, device)
            tensors = list(ex.arg_dict.values()) + \
                list(ex.aux_dict.values()) + store + list(hyper) + \
                [g[2] for g in groups if g[2] is not None]
            for st in states:
                tensors += _leaves(st)
            gens = step_generators(ex._plan, device)
            key = (("inputs", tuple((n, tuple(t.shape), str(t.dtype))
                                    for n, t in ex.arg_dict.items())),
                   ("optimizer", opt_.fused_hyper_key()),
                   ("storage", tuple(t.data_ptr() for t in tensors)),
                   ("generator", tuple(id(g) for g in gens)))
            # the executor's fused step: the out-of-memory chokepoint and
            # its fault site, on the host before the replay call
            with trace_span("fused_step", cat="executor"), \
                    _memory.oom_guard("executor.fused_step"):
                _fi_fire("memory.oom", at="executor")
                outs = graph.run(key, lambda: self._fused_body(
                    names, ukeys, weights, states, store, groups, hyper),
                    device, gens)
        except Exception:
            rollback()
            raise
        upd.hyper_cache.commit(ukeys, device, counts_t)
        ex._outputs = list(outs)
        ex._graph = None
        self._params_dirty = True
        self._fused_stepped = True
        return True

    def _fused_where(self):
        plan = self._exec._plan
        stage = self.__dict__.get("_fstep_stage")
        if stage == "forward" and plan.running is not None:
            s = plan.steps[plan.running]
            return f"the forward, node {s.node.name!r} (op {s.op.name})"
        return stage or "the step"

    def _fused_body(self, names, ukeys, weights, states, store, groups,
                    hyper):
        """Forward, backward with ones as the head gradients, the aux
        write-back and the update, in place; returns the outputs."""
        from ..gluon.wholestep import fused_update
        from ..ndarray.register import write_back
        ex = self._exec
        opt_ = self._fused_step_updater().optimizer
        self._fstep_stage = "forward"
        leaves = [w.detach().requires_grad_() for w in weights]
        with torch.enable_grad():
            outs, new_aux = ex._plan.run(
                {**ex.arg_dict, **dict(zip(names, leaves))}, ex.aux_dict,
                is_train=True)
        self._fstep_stage = "the backward"
        heads = [o for o in outs if o.requires_grad]
        grads = torch.autograd.grad(heads, leaves,
                                    [torch.ones_like(o) for o in heads],
                                    allow_unused=True) \
            if heads else [None] * len(leaves)
        with torch.no_grad():
            grads = [torch.zeros_like(w) if g is None else g
                     for g, w in zip(grads, weights)]
            self._fstep_stage = "the aux write-back"
            write_back((tgt, new_aux[n]) for n, tgt in ex.aux_dict.items()
                       if n in new_aux)
            self._fstep_stage = "the fused update"
            fused_update(opt_, ukeys, weights, grads, states, groups, hyper)
            hyper.t.add_(1)
            for s, w in zip(store, weights):
                s.copy_(w)
        self._fstep_stage = None
        return [o.detach() for o in outs]

    def update(self):
        """Apply the optimizer to every parameter with a gradient (parity:
        _update_params_on_kvstore / _update_params, model.py:97-138); after
        a fused step, nothing."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        if self.__dict__.pop("_fused_stepped", False):
            return
        self._params_dirty = True
        live = [(i, n) for i, n in enumerate(self._param_names)
                if n in self._exec.grad_dict]
        names = [n for _, n in live]
        grads = [self._exec.grad_dict[n] for n in names]
        if self._kvstore is not None:
            if self._update_on_kvstore:
                self._kvstore.pushpull(
                    names, [[g] for g in grads],
                    out=[[self._exec.arg_dict[n]] for n in names])
                return
            aggs = [torch.zeros_like(g) for g in grads]
            self._kvstore.pushpull(names, [[g] for g in grads],
                                   out=[[a] for a in aggs])
            grads = aggs
        self._updater.update_all([i for i, _ in live], grads,
                                 [self._exec.arg_dict[n] for n in names])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self._output_names, self.get_outputs())))

    def install_monitor(self, mon):
        assert self.binded
        mon.install(self._exec)

    def _state_updater(self):
        assert self.optimizer_initialized
        updater = self._kvstore._updater if self._update_on_kvstore \
            else self._updater
        if updater is None:
            raise MXNetError("no optimizer set")
        return updater

    def get_optimizer_states_bytes(self) -> bytes:
        """The updater's states with the optimizer, whose update counts
        Adam's bias correction and the lr schedulers read (the JAX package
        writes the states alone, and a resumed Adam restarts its bias
        correction there): the checkpoint module's Module surface,
        ``fit(checkpoint_dir=...)``."""
        return self._state_updater().get_states(dump_optimizer=True)

    def set_optimizer_states_bytes(self, payload: bytes) -> None:
        """Inverse of ``get_optimizer_states_bytes``; also reads the JAX
        package's files, which carry the states alone."""
        updater = self._state_updater()
        updater.set_states(payload)
        self._optimizer = updater.optimizer
        if self._update_on_kvstore:
            self._kvstore._optimizer = updater.optimizer

    def _resume(self, ckpt, checkpoint_dir) -> int:
        """``fit``'s restore; a store that updates holds its own copy of
        the weights, which ``init_optimizer`` took from the fresh ones, so
        it takes the restored ones (the JAX package's store keeps the
        fresh ones: ROADMAP.md §3)."""
        epoch = super()._resume(ckpt, checkpoint_dir)
        if epoch and self._update_on_kvstore:
            for name in self._param_names:
                self._kvstore.init(name, self._exec.arg_dict[name])
        return epoch

    def save_optimizer_states(self, fname):
        """Write the states to ``fname`` atomically (``nd.write_atomic``)."""
        write_atomic(fname, self.get_optimizer_states_bytes())

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self.set_optimizer_states_bytes(f.read())

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes, sharing the tensors whose shapes
        are unchanged (the parameters)."""
        assert self.binded
        self._data_shapes = [_desc(d) for d in data_shapes]
        self._label_shapes = [_desc(d) for d in label_shapes] \
            if label_shapes else []
        self._exec = self._exec.reshape(
            **{d.name: tuple(d.shape)
               for d in self._data_shapes + self._label_shapes})

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
