"""K whole training steps as one captured CUDA graph (parity:
``mxnet_tpu/autotune/superstep.py``).

``SuperStepCompiler`` extends ``WholeStepCompiler``: ``superstep(datas,
labels)`` runs K whole steps, the same step function K times in a row over
K staged input slots, and returns the K per-sample losses stacked.  The
JAX package scans its step program over the K batches; here the K steps
are captured into one graph, each reading its own static input slot and
its own row of the learning rates and weight decays (K rows, so a
schedule that moves inside a superstep is followed step by step), with the
weights, states, residuals, scaler and the applied-step counter carried
from one step to the next in place.  The first superstep of a
configuration runs its K steps eagerly (real steps), the next captures
them and replays once; in float32 a superstep equals K sequential whole
steps bitwise.

K resolves as ``MXNET_SUPERSTEP_K`` > the constructor's ``k`` > the
persisted ``superstep_k`` decision for this model on this card > 4.  What
the whole step cannot take demotes the call to K single steps (which
themselves run the fused path when ineligible), with one warning.

Before staging K batches a call asks the memory ledger for their bytes
(``memory.ensure_headroom``, against ``MXNET_HBM_BUDGET_MB``); a refusal
demotes that call to K single steps and leaves the superstep viable for
the next call.  Each superstep fires ``trainer.step`` once, before
anything advances, and ``device.unavailable`` before the replay call,
which is a ``superstep`` span inside ``memory.oom_guard``.
"""
from __future__ import annotations

import logging

import torch

from .. import autograd
from ..base import MXNetError, getenv
from ..faultinject import fire as _fi_fire
from ..observability import flight as _flight
from ..observability import introspect as _introspect
from ..observability import journal as _journal
from ..observability import memory as _memory
from ..observability import metrics as _metrics
from ..observability.tracing import trace_span
from ..gluon.parameter import DeferredInitializationError
from ..gluon.wholestep import StepGraph, WholeStepCompiler, \
    _AmpIneligible, _Ineligible, amp_policy, count_snapshot, step_generators
from ..optimizer import DeviceHypers
from . import decisions as _decisions

logger = logging.getLogger("mxnet_tpu_torch.autotune.superstep")

#: K when neither the environment, the constructor nor a decision sets it
DEFAULT_K = 4


class _SuperIneligible(RuntimeError):
    """THIS call cannot run as a superstep (the memory ledger refused
    headroom for staging its K batches): demote it to K=1 without
    demoting the compiler."""


class SuperStepCompiler(WholeStepCompiler):
    """K whole training steps per call, as one captured graph on the card.

    ::

        stepper = SuperStepCompiler(net, loss_fn, trainer)
        for datas, labels in groups_of(stepper.k):
            losses = stepper.superstep(datas, labels)   # (K, batch)

    ``datas``/``labels``: lists of K same-shaped batches, or tensors with a
    leading K axis.  ``step`` (inherited) still runs single whole steps."""

    def __init__(self, net, loss_fn, trainer, k=None):
        super().__init__(net, loss_fn, trainer)
        self._k_arg = k
        self._super_warned = False
        self._stack_cache = {}
        self._super_graph = StepGraph("superstep", self._where)
        self._super_ran = False

    @property
    def k(self) -> int:
        """``MXNET_SUPERSTEP_K`` > constructor ``k`` > the persisted
        decision for this model and card > 4."""
        env_k = int(getenv("MXNET_SUPERSTEP_K", 0))
        if env_k > 0:
            return env_k
        if self._k_arg is not None:
            return max(1, int(self._k_arg))
        sig = self.decision_signature
        if sig is not None:
            dk = _decisions.knob(sig, "superstep_k", None)
            if dk is not None:
                return max(1, int(dk))
        return DEFAULT_K

    @property
    def decision_signature(self):
        """The decision key of this model (None until the step is built)."""
        if self._built is None:
            return None
        return _decisions.model_signature(self._built["sig"])

    @property
    def super_active(self) -> bool:
        """True once a superstep (not a demoted call) has run."""
        return self._super_ran

    @property
    def super_captures(self):
        """Why each superstep graph was captured, in order."""
        return list(self._super_graph.captures)

    def superstep(self, datas, labels, batch_size=None):
        """``len(datas)`` training steps; returns their losses stacked on
        axis 0."""
        datas, labels, k = self._normalize(datas, labels)
        bs = batch_size if batch_size is not None else int(datas[0].shape[0])
        if k == 1 or self._fallback_reason is not None \
                or not getenv("MXNET_WHOLE_STEP", False):
            if k > 1:
                self._warn_demoted("MXNET_WHOLE_STEP is not enabled"
                                   if self._fallback_reason is None
                                   else self._fallback_reason)
            return self._sequential(datas, labels, bs)
        if autograd.is_recording():
            raise MXNetError(
                "SuperStepCompiler.superstep() must not be called inside "
                "autograd.record() — it manages forward/backward itself")
        policy = amp_policy()
        try:
            built = self._ensure_built()
            return self._run_super(built, datas, labels, bs, policy, k)
        except DeferredInitializationError:
            return self._sequential(datas, labels, bs)
        except _SuperIneligible as e:
            # per-call demotion: the superstep stays viable
            self._warn_demoted(str(e))
            return self._sequential(datas, labels, bs)
        except _AmpIneligible as e:
            self._warn_demoted(str(e))
            return self._sequential(datas, labels, bs)
        except _Ineligible as e:
            self._warn_demoted(str(e))
            self._note_fallback(str(e))
            return self._sequential(datas, labels, bs)

    @staticmethod
    def _ask_headroom(datas, labels, k) -> None:
        """Ask the memory ledger for the K staged batches' bytes before
        staging them; a refusal raises ``_SuperIneligible``."""
        if not _memory.ENABLED:
            return
        need = sum(_memory.nbytes_of(a) for a in (datas[0], labels[0])) * k
        if not _memory.ensure_headroom(
                need, why=f"superstep staging (K={k} batches)"):
            raise _SuperIneligible(
                f"the memory ledger refused {need} bytes of headroom for "
                f"staging K={k} batches")

    def _warn_demoted(self, reason: str) -> None:
        if not self._super_warned:
            logger.warning(
                "superstep demoted to K=1 whole-step (%s) — steps run "
                "one at a time", reason)
            self._super_warned = True

    def _sequential(self, datas, labels, bs):
        """K whole steps one at a time (a demoted superstep): the
        superstep's dispatch gauge reads about K."""
        d0 = _metrics.step_dispatches()
        out = torch.stack([self.step(d, l, batch_size=bs)
                           for d, l in zip(datas, labels)])
        if _metrics.ENABLED:
            _metrics.SUPERSTEP_DISPATCHES.set(_metrics.step_dispatches() - d0)
        return out

    @staticmethod
    def _normalize(datas, labels):
        if isinstance(datas, (list, tuple)):
            if not isinstance(labels, (list, tuple)) \
                    or len(labels) != len(datas) or not datas:
                raise MXNetError(
                    "superstep: datas and labels must be same-length "
                    "non-empty lists (or both tensors with a leading K "
                    "axis)")
            return list(datas), list(labels), len(datas)
        return list(datas.unbind(0)), list(labels.unbind(0)), \
            int(datas.shape[0])

    def _rows(self, name, rows, device):
        """A (K, n) float64 tensor of per-step values, written in place only
        when they change."""
        ent = self._stack_cache.get((name, device))
        if ent is None or ent[1].shape != (len(rows), len(rows[0])):
            ent = (None, torch.empty((len(rows), len(rows[0])),
                                     dtype=torch.float64, device=device))
        if ent[0] != rows:
            ent[1].copy_(torch.tensor(rows, dtype=torch.float64))
        self._stack_cache[(name, device)] = (rows, ent[1])
        return ent[1]

    def _run_super(self, built, datas, labels, bs, policy, k):
        tr = self.trainer
        # one fault site per superstep, before anything advances
        _fi_fire("trainer.step", step=tr._step_id)
        d0 = _metrics.step_dispatches()
        self._ask_headroom(datas, labels, k)
        thr, scaler = self._prepare(built, policy, bs)
        upd = tr._updater
        opt_ = upd.optimizer
        idx = built["idx"]
        device = built["device"]
        rollback = count_snapshot(opt_, idx)
        lr_rows, wd_rows = [], []
        try:
            for s in range(k):
                for i in idx:
                    opt_._update_count(i)
                if s == 0:
                    # seeded where a first sequential step would seed it
                    hyper, counts0 = upd.hyper_cache.arrays(
                        opt_, idx, device, pending_ts=self._pending_ts(idx))
                lr_rows.append(tuple(opt_._get_lr(i) for i in idx))
                wd_rows.append(tuple(opt_._get_wd(i) for i in idx))
            lrk = self._rows("lr", tuple(lr_rows), device)
            wdk = self._rows("wd", tuple(wd_rows), device)
            xs = [self._feed("data", s, d, device)
                  for s, d in enumerate(datas)]
            ys = [self._feed("label", s, l, device)
                  for s, l in enumerate(labels)]
            args = self._step_args(built, policy, thr, scaler)
            gens = step_generators(built["plan"], device)
            key = self._key(built, policy, thr, scaler, opt_, xs + ys,
                            args, list(hyper) + [lrk, wdk], gens) + \
                (("K", k),)

            def body():
                return torch.stack([
                    self._body(built, policy, thr, scaler, xs[s], ys[s],
                               DeviceHypers(lrk[s], wdk[s], hyper.t,
                                            hyper.rescale), *args)
                    for s in range(k)])

            _fi_fire("device.unavailable", step=tr._step_id)
            with trace_span("superstep", cat="trainer"), \
                    _flight.phase_span("superstep", cat="step",
                                       step=tr._step_id, watch=True,
                                       mem=True, labels={"k": k}), \
                    _memory.oom_guard("superstep.step"):
                losses = self._super_graph.run(
                    key, body, device, gens,
                    count=self._note(built, policy, thr, opt_, xs[:1] + ys[:1],
                                     k=k))
        except Exception:
            rollback()
            raise
        upd.hyper_cache.commit(idx, device, counts0, steps=k)
        self._super_ran = True
        upd.dtype_policy = policy
        tr._applied_ts = (idx, hyper.t)
        tr._step_id += k
        if _metrics.ENABLED:
            delta = _metrics.step_dispatches() - d0
            _metrics.SUPERSTEP_DISPATCHES.set(delta)
            _metrics.TRAINER_STEP_DISPATCHES.set(delta / float(k))
        if _introspect.ENABLED:
            _introspect.sentinel_tick("superstep")
        if _journal.ENABLED:
            _journal.maybe_milestone(tr._step_id, source="superstep")
        return losses.clone()
