"""gluon.Trainer (parity: python/mxnet/gluon/trainer.py:27,108-127,156).

The counterpart of ``mxnet_tpu/gluon/trainer.py`` on one device: it
applies an Optimizer to a ParameterDict.  The kvstore follows the JAX
package's rules (``model._create_kvstore``): on one device a kvstore name
without "dist" or "tpu" gives none, and ``step`` is ``update`` with the
gradients rescaled by 1/batch_size through the ``FusedUpdater``, one
``update_all`` over every live parameter (``MXNET_FUSED_TRAINER=0`` pins
the per-key loop: kept only because the JAX package reads the same
variable, it gives the same bits more slowly); a ``KVStore`` instance, or
a "tpu"/"nccl" name, gives a one-device store, created at the first step,
and ``step`` pushes the gradients to it and pulls the weights back
(``pushpull``): the optimizer runs on the store, unless
``update_on_kvstore=False``, where the store only reduces (over one
device) and the updater runs here.

A gradient that no backward has rewritten since the last step raises
``UserWarning`` (the reference's stale-gradient error), or with
``ignore_stale_grad=True`` leaves its parameter out of the update (the
kvstore route masks nothing, as in the reference).

``save_states`` / ``load_states`` (and their bytes forms, the checkpoint
module's surface) write and read the JAX package's files: without
gradient compression or a loss scaler, the raw updater pickle with the
optimizer.  After a load the optimizer's ``param_dict`` points back at
this trainer's parameters.

Not ported yet, and raising ``NotImplementedError`` that names the item:
a distributed kvstore (ROADMAP.md, queue item 6), parameters on several
devices (item 6), gradient compression and the fp16 loss scaler (queue
item 4), also where a state file carries their state.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError, getenv
from ..model import _create_kvstore
from ..ndarray import ndarray as _nd
from .parameter import Parameter, ParameterDict


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._params.append(param)
        if isinstance(kvstore, str) and "dist" in kvstore:
            raise NotImplementedError(
                f"Trainer(kvstore={kvstore!r}): distributed kvstores are not "
                "ported yet (ROADMAP.md, queue item 6: scale-out)")
        if compression_params:
            raise NotImplementedError(
                "Trainer(compression_params=...): gradient compression is "
                "not ported yet (ROADMAP.md, queue item 4: the fused step)")
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore = kvstore
        self._update_on_kvstore_arg = update_on_kvstore
        self._kv_initialized = False
        self._fused = bool(getenv("MXNET_FUSED_TRAINER", True))

    def _param_dict(self):
        return {i: param for i, param in enumerate(self._params)}

    def _init_optimizer(self, optimizer, optimizer_params):
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = self._param_dict()
        else:
            self._optimizer = opt.create(optimizer,
                                         param_dict=self._param_dict(),
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    def _init_kvstore(self):
        """The store by ``_create_kvstore``'s rules, each parameter's weight
        stored under its index, the optimizer set on it unless
        ``update_on_kvstore=False``."""
        kvstore, update_on_kvstore = _create_kvstore(
            self._kvstore, 1, {p.name: p.data() for p in self._params})
        if self._update_on_kvstore_arg is not None:
            update_on_kvstore = bool(self._update_on_kvstore_arg)
            if update_on_kvstore and kvstore is None:
                raise ValueError(
                    "update_on_kvstore=True requires a kvstore, but "
                    f"kvstore={self._kvstore!r} resolves to none on one "
                    "device — set update_on_kvstore=False or pass a kvstore")
        if kvstore is not None:
            for i, param in enumerate(self._params):
                kvstore.init(i, param.data())
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
        self._kv = kvstore
        self._update_on_kvstore = update_on_kvstore and kvstore is not None
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr_scheduler(self._optimizer.num_update) \
            if self._optimizer.lr_scheduler else self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step with the gradients scaled by
        1/batch_size."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._optimizer.rescale_grad = self._scale / batch_size
            # the reference never masks the kvstore's push set
            live = self._live(ignore_stale_grad, mask=False)
            self._kv.pushpull([i for i, _ in live],
                              [p.list_grad() for _, p in live],
                              out=[p.list_data() for _, p in live])
            for _, p in live:
                p.fresh_grad = False
            return
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce each gradient through the kvstore, if there is one (over
        one device: the gradient itself)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kv is None:
            return
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        grads = [p.list_grad() for _, p in live]
        self._kv.pushpull([i for i, _ in live], grads, out=grads)

    def _live(self, ignore_stale_grad, mask=True):
        """The (index, parameter) pairs to update.  A stale gradient raises
        ``UserWarning`` unless ``ignore_stale_grad``, and then leaves its
        parameter out when ``mask``."""
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        for _, p in live:
            if len(p.list_ctx()) > 1:
                raise NotImplementedError(
                    f"Parameter {p.name} lives on {len(p.list_ctx())} "
                    "devices: training over several devices is not ported "
                    "yet (ROADMAP.md, queue item 6: scale-out)")
        if ignore_stale_grad:
            return [(i, p) for i, p in live if p.fresh_grad or not mask]
        for _, p in live:
            if not p.fresh_grad:
                raise UserWarning(
                    f"Gradient of Parameter `{p.name}` on context "
                    f"{p.list_ctx()[0]} has not been updated by backward "
                    "since last `step`. This could mean a bug in your "
                    "model that made it only use a subset of the "
                    "Parameters (Blocks) for this iteration. If you are "
                    "intentionally only using a subset, call step with "
                    "ignore_stale_grad=True to suppress this warning and "
                    "skip updating of Parameters with stale gradient")
        return live

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise ValueError("update() when the optimizer runs on the "
                             "kvstore: call step() instead")
        self._optimizer.rescale_grad = self._scale / batch_size
        live = self._live(ignore_stale_grad)
        if self._fused:
            self._updater.update_all([i for i, _ in live],
                                     [p.grad() for _, p in live],
                                     [p.data() for _, p in live])
        else:
            for i, p in live:
                self._updater(i, p.grad(), p.data())
        for _, p in live:
            p.fresh_grad = False

    # -- optimizer states ----------------------------------------------------
    def _state_updater(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            if self._kv._updater is None:
                raise MXNetError("no optimizer set")
            return self._kv._updater
        return self._updater

    def get_states_bytes(self) -> bytes:
        """The updater's states with the optimizer, as ``save_states``
        writes them (the checkpoint module's trainer surface)."""
        return self._state_updater().get_states(dump_optimizer=True)

    def set_states_bytes(self, payload: bytes) -> None:
        """Inverse of ``get_states_bytes``; also reads the JAX package's
        files, raw or in its ``__mxt_trainer_states__`` wrapper.  A
        wrapper carrying compression residuals or a loss scaler raises
        ``NotImplementedError`` before anything is loaded."""
        updater = self._state_updater()
        obj = _nd.loads(payload)
        if isinstance(obj, dict) and obj.get("__mxt_trainer_states__") == 1:
            extras = [k for k in ("bucket", "kv_residuals", "scaler")
                      if obj.get(k)]
            if extras:
                raise NotImplementedError(
                    f"Trainer.set_states_bytes: the file carries {extras}: "
                    "gradient compression and the fp16 loss scaler are not "
                    "ported yet (ROADMAP.md, queue item 4)")
            payload = obj["updater"]
        updater.set_states(payload)
        self._optimizer = updater.optimizer
        self._optimizer.param_dict = self._param_dict()
        if self._update_on_kvstore:
            self._kv._optimizer = self._optimizer
        else:
            self._updater = updater

    def save_states(self, fname):
        """Write the states to ``fname`` atomically (``nd.write_atomic``)."""
        _nd.write_atomic(fname, self.get_states_bytes())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.set_states_bytes(f.read())
