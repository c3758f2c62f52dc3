"""gluon.Trainer (parity: python/mxnet/gluon/trainer.py:27,108-127,156).

The counterpart of ``mxnet_tpu/gluon/trainer.py`` on one device: it
applies an Optimizer to a ParameterDict through the per-parameter
``Updater``.  On one device the JAX package creates no kvstore
(``mxnet_tpu/model.py:_create_kvstore`` gives none for a kvstore name
without "dist" or "tpu"), so ``allreduce_grads`` has nothing to reduce and
``step`` is ``update`` with the gradients rescaled by 1/batch_size.

A gradient that no backward has rewritten since the last step raises
``UserWarning`` (the reference's stale-gradient error), or with
``ignore_stale_grad=True`` leaves its parameter out of the update.

Not ported yet, and raising ``NotImplementedError`` that names the item:
a kvstore object or a distributed kvstore name (ROADMAP.md, queue items
3 and 6), parameters on several devices (item 6), gradient compression
and ``save_states`` / ``load_states`` (queue item 4: the JAX package
pickles its optimizer objects there).
"""
from __future__ import annotations

from .. import optimizer as opt
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
        if kvstore is not None and not (
                isinstance(kvstore, str) and "dist" not in kvstore
                and "tpu" not in kvstore):
            raise NotImplementedError(
                f"Trainer(kvstore={kvstore!r}): kvstores are not ported yet "
                "(ROADMAP.md, queue item 3: local/device kvstore; item 6: "
                "distributed)")
        if compression_params:
            raise NotImplementedError(
                "Trainer(compression_params=...): gradient compression is "
                "not ported yet (ROADMAP.md, queue item 4: the fused step)")
        if update_on_kvstore:
            raise ValueError(
                "update_on_kvstore=True requires a kvstore, but "
                f"kvstore={kvstore!r} resolves to none on one device — set "
                "update_on_kvstore=False or pass a kvstore")
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.lr_scheduler(self._optimizer.num_update) \
            if self._optimizer.lr_scheduler else self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step with the gradients scaled by
        1/batch_size."""
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce: the parameters live on one device."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        for _, p in live:
            if len(p.list_ctx()) > 1:
                raise NotImplementedError(
                    f"Parameter {p.name} lives on {len(p.list_ctx())} "
                    "devices: training over several devices is not ported "
                    "yet (ROADMAP.md, queue item 6: scale-out)")
        if ignore_stale_grad:
            live = [(i, p) for i, p in live if p.fresh_grad]
        else:
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
        for i, p in live:
            self._updater(i, p.grad(), p.data())
            p.fresh_grad = False

    def save_states(self, fname):
        raise NotImplementedError(f"Trainer.save_states: {opt._STATES_ITEM}")

    def load_states(self, fname):
        raise NotImplementedError(f"Trainer.load_states: {opt._STATES_ITEM}")
