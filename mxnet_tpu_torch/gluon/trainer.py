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

With a store that only reduces, the fused path reduces flat gradient
buckets (parity: ``mxnet_tpu/gluon/trainer.py:288-480``): the dense
gradients are concatenated into buckets of at most
``MXNET_BUCKET_SIZE_MB`` (32 by default; with it unset and
``MXNET_AUTOTUNE`` on, a persisted ``autotune.decisions`` value), reduced
by one ``KVStore.allreduce``, and the update reads each gradient as a view
into them.  ``compression_params={"type": "2bit", "threshold": t}`` sets
the store's 2-bit compression: the buckets are quantized against one flat
float32 residual per bucket (each parameter's residual is its slice, so
the error feedback is the per-key quantizer's), updated in place.  The
whole-step program (``gluon.wholestep``) shares the bucketer and the
residuals, and keeps the fp16 loss scaler here (``loss_scale``, device
scalars ``MXNET_LOSS_SCALE_INIT`` 65536 and a growth window
``MXNET_LOSS_SCALE_WINDOW`` 200) with the applied-step counter.

``save_states`` / ``load_states`` (and their bytes forms, the checkpoint
module's surface) write and read the JAX package's files: without
gradient compression or a loss scaler, the raw updater pickle with the
optimizer; with them, the ``__mxt_trainer_states__`` wrapper that also
carries the bucket residuals (``bucket``), the store's per-key residuals
(``kv_residuals``) and the scaler with the applied-step counts
(``scaler``).  After a load the optimizer's ``param_dict`` points back at
this trainer's parameters; residuals saved for another bucket layout
raise ``MXNetError`` when the bucketer is built.

Each ``step`` is a ``trainer_step`` span (``trace_span`` and a watched
flight-recorder phase sampling the memory ledger), fires the
``trainer.step`` fault site before it writes anything, and leaves a run
journal milestone; the bucketed reduce is an ``allreduce`` phase.  The
memory ledger tags the gradients (``grad``), the buckets
(``grad_bucket``), the residuals (``compression_residual``) and the
scaler (``optimizer_state``).  Each step publishes the dispatches it
issued (``TRAINER_STEP_DISPATCHES``) and ticks the introspector's perf
sentinel for the ``trainer_step`` phase.

Not ported yet, and raising ``NotImplementedError`` that names the item:
a distributed kvstore (ROADMAP.md, queue item 6) and parameters on
several devices (item 6).
"""
from __future__ import annotations

import os

import numpy as _np
import torch

from .. import optimizer as opt
from ..analysis import sanitizer as _san
from ..base import MXNetError, getenv
from ..faultinject import fire as _fi_fire
from ..model import _create_kvstore
from ..ndarray import ndarray as _nd
from ..observability import flight as _flight
from ..observability import introspect as _introspect
from ..observability import journal as _journal
from ..observability import memory as _memory
from ..observability import metrics as _metrics
from ..observability.tracing import trace_span
from .parameter import Parameter, ParameterDict


def dtype_name(dtype) -> str:
    """A torch dtype as the JAX package's signatures name it ("float32")."""
    return str(dtype).replace("torch.", "")


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
        self._compression_params = compression_params
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore = kvstore
        self._update_on_kvstore_arg = update_on_kvstore
        self._kv_initialized = False
        self._fused = bool(getenv("MXNET_FUSED_TRAINER", True))
        self._bucketer = None
        self._bucket_sig = None
        # per-parameter views into the reduced buckets, staged by a step's
        # allreduce for its update: (views, indices)
        self._reduced = None
        # one flat float32 residual per bucket, and residuals a state file
        # brought before the bucketer existed: (bucket signature, arrays)
        self._residuals = None
        self._pending_residuals = None
        # the fp16 loss scaler (device scalars) and the applied-step
        # counter the whole-step program keeps beside it: (indices, t)
        self._scaler = None
        self._applied_ts = None
        self._applied_ts_pending = None
        # training steps taken through this trainer (the whole step and
        # the superstep advance it too): the spans' and faults' step id
        self._step_id = 0

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
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
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
        d0 = _metrics.step_dispatches()
        with trace_span("trainer_step", cat="optimizer"), \
                _flight.phase_span("trainer_step", cat="step",
                                   step=self._step_id, watch=True,
                                   mem=True):
            self._step(batch_size, ignore_stale_grad)
        self._step_id += 1
        if _metrics.ENABLED:
            _metrics.TRAINER_STEP_DISPATCHES.set(
                _metrics.step_dispatches() - d0)
        if _introspect.ENABLED:
            _introspect.sentinel_tick("trainer_step")
        if _journal.ENABLED:
            _journal.maybe_milestone(self._step_id, source="trainer")

    def _step(self, batch_size, ignore_stale_grad):
        if not self._kv_initialized:
            self._init_kvstore()
        # fires before any parameter or state is written, so an injected
        # raise is a step that failed without consuming state
        _fi_fire("trainer.step", step=self._step_id)
        if _memory.ENABLED:
            self._register_grads()
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
        self._allreduce_grads(for_step=True)
        self.update(batch_size, ignore_stale_grad)

    def _register_grads(self) -> None:
        """Tag the live gradient buffers (torch makes them at the first
        backward; re-registering a tracked one costs a dict lookup)."""
        for p in self._params:
            if p.grad_req != "null" and p._data is not None and \
                    p._data.grad is not None:
                _memory.register(p._data.grad, tag="grad")

    def allreduce_grads(self):
        """Reduce each gradient through the kvstore, if there is one (over
        one device: the gradient itself, through the compression when it
        is set)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self, for_step=False):
        """The fused path reduces the gradients as flat buckets; for a
        step, the update then reads views into them (``_reduced``),
        otherwise they are written back into the gradient buffers.
        ``MXNET_FUSED_TRAINER=0`` and a store that updates push key by
        key."""
        self._reduced = None
        if self._kv is None:
            return
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not live:
            return
        if not self._fused or self._update_on_kvstore:
            grads = [p.list_grad() for _, p in live]
            self._kv.pushpull([i for i, _ in live], grads, out=grads)
            return
        views, idx = self._bucketed_pushpull(live)
        if for_step:
            self._reduced = (views, idx)
            return
        with torch.no_grad():
            for (_, p), g in zip(live, views):
                if g is not p.grad():
                    p.grad().copy_(g)

    def _bucketed_pushpull(self, dense):
        """Flatten the gradients into buckets, reduce them in one
        ``KVStore.allreduce`` (2-bit compressed against the residuals when
        the store compresses) and return (per-parameter views into the
        reduced buckets, indices)."""
        grads = [p.grad() for _, p in dense]
        sig = tuple((tuple(g.shape), dtype_name(g.dtype)) for g in grads)
        idx = tuple(i for i, _ in dense)
        bk = self._ensure_bucketer(sig, idx)
        gc = self._kv._gc
        with torch.no_grad(), trace_span("bucketed_allreduce",
                                         cat="kvstore"), \
                _flight.phase_span("allreduce", cat="kvstore",
                                   step=self._step_id, mem=True), \
                _metrics.dispatch_unit("allreduce"):
            flats = bk.flatten(grads)
            if _memory.ENABLED:
                for f in flats:
                    _memory.register(f, tag="grad_bucket")
            if gc is not None:
                if self._residuals is None:
                    self._residuals = self._init_residuals(bk)
                reduced, new_res = self._kv.allreduce(
                    flats, compression=gc, residuals=self._residuals)
                # in place: a captured whole-step reads these addresses
                torch._foreach_copy_(self._residuals, new_res)
            else:
                reduced = self._kv.allreduce(flats)
        return bk.unflatten(reduced), idx

    def _ensure_bucketer(self, sig, idx):
        """The ``GradBucketer`` for this dense-gradient signature, built
        anew (and the residuals restarted) when it changes; shared with
        the whole-step program, so a state file written under one path
        restores under the other."""
        from ..kvstore import GradBucketer
        if self._bucketer is None or self._bucket_sig != (sig, idx):
            mb = None
            if "MXNET_BUCKET_SIZE_MB" not in os.environ:
                from ..autotune import decisions as _decisions
                if _decisions.ENABLED:
                    mb = _decisions.knob(_decisions.model_signature(sig),
                                         "bucket_size_mb", None)
            cap = int(float(getenv("MXNET_BUCKET_SIZE_MB", 32.0)
                            if mb is None else mb) * 1024 * 1024)
            self._bucketer = GradBucketer(sig, cap)
            self._bucket_sig = (sig, idx)
            self._residuals = None
        return self._bucketer

    def _device(self):
        return next(p.data().device for p in self._params
                    if p.grad_req != "null")

    def _ensure_scaler(self):
        """The fp16 loss scaler: the scale and the count of consecutive
        finite steps as device scalars, which the whole-step program reads
        and updates in place (x2 after ``window`` finite steps, x0.5, at
        least 1, on a nonfinite gradient, whose step is skipped)."""
        if self._scaler is None:
            self._scaler = self._make_scaler(
                getenv("MXNET_LOSS_SCALE_INIT", 65536.0), 0,
                getenv("MXNET_LOSS_SCALE_WINDOW", 200), self._device())
        return self._scaler

    @staticmethod
    def _make_scaler(scale, good, window, device):
        out = {"scale": torch.tensor(float(scale), dtype=torch.float32,
                                     device=device),
               "good": torch.tensor(int(good), dtype=torch.int32,
                                    device=device),
               "window": int(window)}
        if _memory.ENABLED:
            _memory.register(out["scale"], tag="optimizer_state")
            _memory.register(out["good"], tag="optimizer_state")
        return out

    @property
    def loss_scale(self) -> float:
        """The dynamic loss scale (1.0 without fp16 loss scaling); reading
        it waits for the device."""
        if self._scaler is None:
            return 1.0
        _san.check_sync("Trainer.loss_scale")
        return float(self._scaler["scale"].item())

    def _init_residuals(self, bk):
        """Zero residuals sized to the bucket layout, or the ones a state
        file brought, which must have been saved for this layout."""
        device = self._device()
        if self._pending_residuals is not None:
            saved_sig, arrays = self._pending_residuals
            if saved_sig != self._bucket_sig or \
                    tuple(int(a.shape[0]) for a in arrays) != bk.sizes:
                raise MXNetError(
                    "Trainer.load_states: checkpointed compression "
                    "residuals were saved for a different parameter/"
                    f"bucket signature ({len(arrays)} buckets over "
                    f"{len(saved_sig[0])} dense params; current layout "
                    f"has {len(bk.sizes)} buckets over "
                    f"{len(self._bucket_sig[0])} dense params with "
                    "different shapes/dtypes/order). Resuming would "
                    "silently reset 2-bit error feedback — load states "
                    "saved from the same model and bucket layout "
                    "(MXNET_BUCKET_SIZE_MB included).")
            self._pending_residuals = None
            out = [torch.as_tensor(_np.asarray(a, dtype=_np.float32))
                   .to(device) for a in arrays]
        else:
            out = [torch.zeros(n, dtype=torch.float32, device=device)
                   for n in bk.sizes]
        if _memory.ENABLED:
            for r in out:
                _memory.register(r, tag="compression_residual")
        return out

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
        reduced, self._reduced = self._reduced, None
        live = self._live(ignore_stale_grad)
        if self._fused:
            self._updater.dtype_policy = "f32"
            grads = [p.grad() for _, p in live]
            if reduced is not None:
                views, idx = reduced
                pos = {i: j for j, i in enumerate(idx)}
                grads = [views[pos[i]] for i, _ in live]
            self._updater.update_all([i for i, _ in live], grads,
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
        writes them (the checkpoint module's trainer surface), in the
        wrapper when residuals or a scaler ride along."""
        return self._wrap_states(
            self._state_updater().get_states(dump_optimizer=True))

    def _wrap_states(self, states: bytes) -> bytes:
        """The raw updater pickle, or, with compression residuals or a
        loss scaler to keep, the JAX package's ``__mxt_trainer_states__``
        wrapper around it (parity: ``mxnet_tpu/gluon/trainer.py:
        _wrap_states``)."""
        bucket = None
        if self._residuals is not None:
            bucket = {"sig": self._bucket_sig,
                      "residuals": [r.cpu().numpy() for r in self._residuals]}
        elif self._pending_residuals is not None:
            saved_sig, arrays = self._pending_residuals
            bucket = {"sig": saved_sig,
                      "residuals": [_np.asarray(a) for a in arrays]}
        kv_res = {}
        if self._kv is not None and self._kv._residuals:
            kv_res = {k: v.cpu().numpy()
                      for k, v in self._kv._residuals.items()}
        scaler = None
        if self._scaler is not None:
            _san.check_sync("Trainer state read")
            scaler = {"scale": float(self._scaler["scale"].item()),
                      "good": int(self._scaler["good"].item()),
                      "window": int(self._scaler["window"])}
            if self._applied_ts is not None:
                scaler["ts_idx"] = list(self._applied_ts[0])
                scaler["ts"] = [int(t) for t in self._applied_ts[1].tolist()]
        if bucket is None and not kv_res and scaler is None:
            return states
        return _nd.dumps({"__mxt_trainer_states__": 1, "updater": states,
                          "bucket": bucket, "kv_residuals": kv_res,
                          "scaler": scaler})

    def set_states_bytes(self, payload: bytes) -> None:
        """Inverse of ``get_states_bytes``; also reads the JAX package's
        files, raw or in its ``__mxt_trainer_states__`` wrapper, whose
        scaler, applied-step counts and residuals it takes over (replacing
        this trainer's; bucket residuals are checked against the layout
        when the bucketer is built)."""
        updater = self._state_updater()
        obj = _nd.loads(payload)
        extra = None
        if isinstance(obj, dict) and obj.get("__mxt_trainer_states__") == 1:
            extra = obj
            payload = obj["updater"]
        updater.set_states(payload)
        self._optimizer = updater.optimizer
        self._optimizer.param_dict = self._param_dict()
        if self._update_on_kvstore:
            self._kv._optimizer = self._optimizer
        else:
            self._updater = updater
        self._scaler = None
        self._applied_ts = None
        self._applied_ts_pending = None
        if extra is None:
            return
        scaler = extra.get("scaler")
        if scaler is not None:
            self._scaler = self._make_scaler(
                scaler["scale"], scaler["good"], scaler["window"],
                self._device())
            if scaler.get("ts") is not None:
                self._applied_ts_pending = (
                    tuple(scaler["ts_idx"]), [int(t) for t in scaler["ts"]])
        kv_res = extra.get("kv_residuals") or {}
        if kv_res and self._kv is not None:
            self._kv._residuals = {
                k: torch.as_tensor(_np.asarray(v, dtype=_np.float32))
                .to(self._device()) for k, v in kv_res.items()}
        bucket = extra.get("bucket")
        if bucket is None:
            return
        self._pending_residuals = (bucket["sig"], bucket["residuals"])
        self._residuals = None
        if self._bucket_sig is not None:
            self._residuals = self._init_residuals(self._bucketer)

    def save_states(self, fname):
        """Write the states to ``fname`` atomically (``nd.write_atomic``)."""
        _nd.write_atomic(fname, self.get_states_bytes())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.set_states_bytes(f.read())
