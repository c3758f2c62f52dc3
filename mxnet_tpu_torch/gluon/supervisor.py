"""TrainingSupervisor: fault-tolerant training steps (parity:
``mxnet_tpu/gluon/supervisor.py``).

  * **typed fault classification** — every step failure routes through
    ``resilience.classify``: *transient* (UNAVAILABLE, injected chaos)
    retries; *oom* (``DeviceMemoryError``, ``torch.cuda.OutOfMemoryError``)
    and *permanent* (trace/user errors, CUDA's sticky context errors)
    propagate immediately.
  * **retry through a snapshot** — a rolling host snapshot of the
    parameters, the optimizer states, the compression residuals and the
    loss scaler (every ``MXNET_SUPERVISE_SNAPSHOT_STEPS``), plus the
    window of batch references since it.  On a transient failure the
    supervisor restores the snapshot, replays the window, and re-executes
    the failed step; a float32 retried run under deterministic algorithms
    is bitwise the uninterrupted one.
  * **divergence watchdog** — ``MXNET_SUPERVISE_DIVERGE_PATIENCE``
    consecutive nonfinite losses trigger ONE rate-limited post-mortem
    (flight ring + memory ledger report) and then either a typed
    ``DivergenceError`` or a rewind to the last snapshot, per
    ``MXNET_SUPERVISE_ON_DIVERGE=raise|rewind``.
  * **stall watchdog** — steps execute on a worker thread while the
    caller waits on a host queue with a deadline derived from the
    step-duration EWMA (``MXNET_SUPERVISE_STALL_FACTOR`` x EWMA, floored
    at ``MXNET_SUPERVISE_STALL_MIN_S``); a step that blows it
    post-mortems and raises ``TrainingStalledError``, and the supervisor
    is then poisoned.
  * **preemption** — ``install_preemption_hook`` saves, on SIGTERM, the
    last consistent snapshot when the signal lands mid-step.

The card's design:

  * **The snapshot** copies each tensor into a pinned host buffer that is
    allocated once and reused (``non_blocking`` device-to-host copies on
    the caller's stream), then records a CUDA event; the next step's
    stream waits on that event before it writes those tensors in place.
    The JAX package pickles the trainer's states (``get_states_bytes``)
    instead; at the LM's width that is gigabytes through pageable memory.
  * **The restore** ``copy_``s the host buffers back INTO the live
    tensors (and puts the optimizer's host update counts back), so the
    storage a captured CUDA graph reads stays where it was and a retry
    captures nothing.  Where that cannot be done (an optimizer state or
    scaler created after the snapshot), that part is dropped so the next
    step creates it afresh, which moves its storage and makes the next
    step capture again; ``last_restore`` says why.
  * **The worker thread**: torch's current device and stream are per
    thread, so the worker sets the caller's device and runs the step on
    the caller's stream.  While the worker captures a graph the caller
    only waits on a host queue and touches no CUDA.

Overhead contract: ``MXNET_SUPERVISE=0`` reduces ``step()`` to ONE
module-global boolean test and a direct call.

::

    sup = mx.gluon.TrainingSupervisor(stepper.step, trainer=trainer,
                                      params=net)
    for x, y in batches:
        loss = sup.step(x, y)     # retries transients, watches health
"""
from __future__ import annotations

import copy
import itertools
import logging
import math
import queue as _queue
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import torch

from ..analysis import sanitizer as _san
from ..base import MXNetError, getenv
from ..observability import flight as _flight
from ..observability import goodput as _goodput
from ..observability import journal as _journal
from ..observability import memory as _memory
from ..observability import metrics as _metrics
from .. import resilience as _res
from ..resilience import (DivergenceError, StepRetriesExhausted,
                          TrainingStalledError)

log = logging.getLogger(__name__)

__all__ = ["ENABLED", "enable", "disable", "enabled", "TrainingSupervisor"]

# MXNET_SUPERVISE=0: every supervisor hook is one module-global boolean
# test; step() delegates straight to the wrapped step_fn.
ENABLED: bool = bool(getenv("MXNET_SUPERVISE", True))

_EWMA_ALPHA = 0.3   # same smoothing/warmup as the flight watchdog
_EWMA_WARMUP = 5

#: flight phases whose warmed EWMA seeds the stall deadline
_STEP_PHASES = ("trainer_step", "whole_step")


def enabled() -> bool:
    return ENABLED


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def _finite(value) -> bool:
    """Host-side finiteness of a step's returned loss: one boolean read
    back from the device (``isfinite(...).all()``), not the loss itself.
    Unrecognized types count as finite."""
    if value is None:
        return True
    if isinstance(value, (float, int)):
        return math.isfinite(value)
    if isinstance(value, torch.Tensor):
        _san.check_sync("TrainingSupervisor loss check")
        return bool(torch.isfinite(value.detach()).all().item())
    try:
        import numpy as _np
        return bool(_np.isfinite(_np.asarray(value)).all())
    except Exception:  # noqa: BLE001 — non-numeric step results
        return True


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (list, tuple)):
        return [t for s in state for t in _leaves(s)]
    return []


class _Snapshot:
    """Host copies of a training state's tensors, in buffers allocated once
    (pinned for CUDA tensors) and refilled by each capture."""

    def __init__(self):
        self.bufs: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self.names: tuple = ()
        self.host = None
        self.step = None
        self.event = None
        self.waited = False
        self.nbytes = 0

    def capture(self, tensors, host, step) -> float:
        """Copy ``tensors`` (name -> live tensor) into the host buffers and
        record an event; returns the host seconds the call took."""
        t0 = time.perf_counter()
        cuda_dev = None
        with torch.no_grad():
            for name, t in tensors.items():
                buf = self.bufs.get(name)
                if buf is None or buf.shape != t.shape or \
                        buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=t.is_cuda)
                    if _memory.ENABLED:
                        _memory.register(buf, tag="supervisor_snapshot",
                                         space="host")
                    self.bufs[name] = buf
                if t.is_cuda:
                    cuda_dev = t.device
                buf.copy_(t.detach(), non_blocking=t.is_cuda)
        for name in [n for n in self.bufs if n not in tensors]:
            del self.bufs[name]
        self.names = tuple(tensors)
        self.nbytes = sum(b.numel() * b.element_size()
                          for b in self.bufs.values())
        self.host = host
        self.step = step
        self.event = None
        self.waited = False
        if cuda_dev is not None:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(cuda_dev))
        return time.perf_counter() - t0

    def wait_stream(self) -> None:
        """Make the current stream wait for the copies (once per capture:
        later steps follow them in stream order)."""
        if self.event is not None and not self.waited:
            torch.cuda.current_stream().wait_event(self.event)
            self.waited = True

    def host_ready(self) -> None:
        """Block the host until the copies have landed (a host reader)."""
        if self.event is not None:
            self.event.synchronize()


class TrainingSupervisor:
    """Supervise a training-step callable with typed-fault retry,
    divergence and stall watchdogs, and snapshot-consistent preemption.

    Parameters
    ----------
    step_fn : callable
        One training step: ``step_fn(*args, **kw) -> loss``.  Typical
        values: ``WholeStepCompiler(...).step``, or a closure doing
        record/backward/``Trainer.step``.
    trainer : gluon.Trainer, optional
        Its optimizer states (with the kvstore's when the store updates),
        compression residuals and loss scaler are snapshotted and
        restored in place, with the optimizer's host update counts.
    params : Block | ParameterDict | dict, optional
        The model parameters (aux states included).
    snapshot_fn / restore_fn : callable, optional
        Override the state capture: ``snapshot_fn() -> {name: tensor or
        bytes}`` and ``restore_fn({name: host copy})``.
    steps_per_call : int, optional
        Training steps one ``step_fn`` call advances (K under a
        ``SuperStepCompiler.superstep``).  Default 1.
    snapshot_steps / retries / backoff_s / diverge_patience /
    on_diverge / check_every / stall_factor / stall_min_s : optional
        Override the corresponding ``MXNET_SUPERVISE_*`` defaults.
    """

    def __init__(self, step_fn: Callable, trainer=None, params=None,
                 snapshot_fn: Optional[Callable] = None,
                 restore_fn: Optional[Callable] = None,
                 snapshot_steps: Optional[int] = None,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 diverge_patience: Optional[int] = None,
                 on_diverge: Optional[str] = None,
                 check_every: Optional[int] = None,
                 stall_factor: Optional[float] = None,
                 stall_min_s: Optional[float] = None,
                 steps_per_call: Optional[int] = None,
                 _state_fn: Optional[Callable] = None):
        self._step_fn = step_fn
        self._trainer = trainer
        self._pd = None
        if params is not None:
            from ..checkpoint.manager import _as_param_dict
            self._pd = _as_param_dict(params)
        self._snapshot_fn = snapshot_fn
        self._restore_fn = restore_fn
        # (tensors: name -> (tensor, drop or None), optimizers) of a Module
        self._state_fn = _state_fn
        if (self._pd is None and trainer is None and _state_fn is None
                and (snapshot_fn is None) != (restore_fn is None)):
            raise MXNetError("snapshot_fn and restore_fn come as a pair")
        self.snapshot_steps = int(getenv("MXNET_SUPERVISE_SNAPSHOT_STEPS",
                                         50)) \
            if snapshot_steps is None else int(snapshot_steps)
        if self.snapshot_steps < 1:
            raise MXNetError("snapshot_steps must be >= 1")
        self.steps_per_call = 1 if steps_per_call is None \
            else int(steps_per_call)
        if self.steps_per_call < 1:
            raise MXNetError("steps_per_call must be >= 1")
        self.retries = int(getenv("MXNET_SUPERVISE_RETRIES", 2)) \
            if retries is None else int(retries)
        self.backoff_s = float(getenv("MXNET_SUPERVISE_RETRY_BACKOFF_S",
                                      0.05)) \
            if backoff_s is None else float(backoff_s)
        self.diverge_patience = int(getenv(
            "MXNET_SUPERVISE_DIVERGE_PATIENCE", 3)) \
            if diverge_patience is None else int(diverge_patience)
        od = str(getenv("MXNET_SUPERVISE_ON_DIVERGE", "raise")).lower() \
            if on_diverge is None else str(on_diverge).lower()
        if od not in ("raise", "rewind"):
            raise MXNetError(
                f"MXNET_SUPERVISE_ON_DIVERGE must be raise|rewind, got {od!r}")
        self.on_diverge = od
        self.check_every = int(getenv("MXNET_SUPERVISE_CHECK_EVERY", 1)) \
            if check_every is None else int(check_every)
        self.stall_factor = float(getenv("MXNET_SUPERVISE_STALL_FACTOR",
                                         60.0)) \
            if stall_factor is None else float(stall_factor)
        self.stall_min_s = float(getenv("MXNET_SUPERVISE_STALL_MIN_S",
                                        30.0)) \
            if stall_min_s is None else float(stall_min_s)

        self._snap: Optional[_Snapshot] = None
        self._snap_buffers = _Snapshot()
        # batch windows since the snapshot, replayed after a restore
        self._window: list = []
        self._step_count = 0
        self._nonfinite = 0
        self._retry_warned = False
        self._in_step = False
        self._stalled: Optional[str] = None
        self._ewma = 0.0
        self._ewma_n = 0
        self._work_q: Optional[_queue.SimpleQueue] = None
        self._result_q: Optional[_queue.SimpleQueue] = None
        self._worker: Optional[threading.Thread] = None
        #: host seconds of each snapshot capture and each restore
        self.snapshot_seconds: list = []
        self.restore_seconds: list = []
        #: ``{"in_place": bool, "why": str or None}`` of the last restore
        self.last_restore: Optional[dict] = None

    # -- construction helpers ------------------------------------------------
    @classmethod
    def for_module(cls, module, **kw) -> "TrainingSupervisor":
        """Supervise a ``Module``'s fit step: ``step(batch)`` runs
        ``forward_backward`` + ``update`` with the same retry/stall
        machinery; the snapshot holds the bound parameters, the aux
        states, the optimizer states (and the kvstore's copies when it
        updates) and is restored in place (what ``Module.fit(
        supervise=True)`` uses).  The divergence watchdog defaults OFF
        here (``check_every=0``): module outputs are raw head activations,
        not a loss."""
        kw.setdefault("check_every", 0)
        from ..faultinject import fire as _fi_fire

        def step_fn(batch):
            # same chaos site as the gluon paths: one fire per step
            _fi_fire("trainer.step")
            module.forward_backward(batch)
            module.update()
            outs = module.get_outputs()
            return outs[0] if outs else None

        def state_fn():
            ex = module._exec
            tensors = OrderedDict()
            for n in module._param_names:
                tensors[f"arg:{n}"] = (ex.arg_dict[n], None)
            for n, t in ex.aux_dict.items():
                tensors[f"aux:{n}"] = (t, None)
            opts = []
            if module.optimizer_initialized:
                upd = module._state_updater()
                _updater_tensors(upd, "state", tensors)
                opts.append(upd)
                kv = module._kvstore
                if kv is not None and getattr(kv, "_store", None):
                    for k, t in kv._store.items():
                        if isinstance(t, torch.Tensor):
                            tensors[f"kvstore:{k}"] = (t, None)

            def after_restore():
                module._params_dirty = True
            return tensors, opts, after_restore

        return cls(step_fn, _state_fn=state_fn, **kw)

    # -- public entry --------------------------------------------------------
    def step(self, *args, **kw):
        """Run one supervised training step.  With ``MXNET_SUPERVISE=0``
        this is exactly ``step_fn(*args, **kw)`` — one boolean test."""
        if not ENABLED:
            return self._step_fn(*args, **kw)
        if self._stalled is not None:
            raise TrainingStalledError(
                f"supervisor poisoned by an earlier stall ({self._stalled})"
                " — the wedged step may still own the device; restart "
                "the process and resume from the last checkpoint",
                step=self._step_count)
        self._maybe_snapshot()
        if self._can_restore:
            self._window.append((args, kw))
        try:
            out = self._attempt(args, kw)
        except BaseException:
            if self._can_restore:
                self._window.pop()
            raise
        self._step_count += 1
        if _journal.ENABLED:
            _journal.maybe_milestone(
                self._step_count * self.steps_per_call,
                source="supervisor")
        return self._check_divergence(out)

    __call__ = step

    # -- the training state --------------------------------------------------
    @property
    def _can_restore(self) -> bool:
        return (self._restore_fn is not None or self._pd is not None
                or self._trainer is not None or self._state_fn is not None)

    def _live_state(self):
        """(tensors: OrderedDict name -> (live tensor, drop or None),
        optimizers whose host counts ride along, a hook to run after a
        restore or None)."""
        if self._state_fn is not None:
            return self._state_fn()
        if self._snapshot_fn is not None:
            tensors = OrderedDict()
            for name, v in self._snapshot_fn().items():
                tensors[name] = (v, None)
            return tensors, [], None
        tensors = OrderedDict()
        if self._pd is not None:
            for name, p in self._pd.items():
                tensors[f"param:{name}"] = (p.data(), None)
        opts = []
        tr = self._trainer
        if tr is not None:
            upd = tr._state_updater()
            _updater_tensors(upd, "state", tensors)
            opts.append(upd)
            if tr._residuals is not None:
                def drop_res(tr=tr):
                    tr._residuals = None
                for j, r in enumerate(tr._residuals):
                    tensors[f"residual:{j}"] = (r, drop_res)
            if tr._scaler is not None:
                def drop_scaler(tr=tr):
                    tr._scaler = None
                tensors["scaler:scale"] = (tr._scaler["scale"], drop_scaler)
                tensors["scaler:good"] = (tr._scaler["good"], drop_scaler)
            kv = tr._kv
            if kv is not None:
                for k, r in (kv._residuals or {}).items():
                    def drop_kv(kv=kv, k=k):
                        kv._residuals.pop(k, None)
                    tensors[f"kv_residual:{k}"] = (r, drop_kv)
                if tr._update_on_kvstore:
                    for k, t in kv._store.items():
                        if isinstance(t, torch.Tensor):
                            tensors[f"kvstore:{k}"] = (t, None)
        return tensors, opts, None

    @staticmethod
    def _host_counts(upds):
        """Each updater's optimizer update counts and schedule, and what
        its device step counters stand for."""
        out = []
        for u in upds:
            o = u.optimizer
            hc = getattr(u, "hyper_cache", None)
            ts = {k: rec for k, (_t, rec) in hc._ts.items()} \
                if hc is not None else {}
            out.append((o.num_update, dict(o._index_update_count),
                        copy.deepcopy(o.lr_scheduler), ts))
        return out

    @staticmethod
    def _set_host_counts(upds, saved):
        for u, (nu, counts, sched, ts) in zip(upds, saved):
            o = u.optimizer
            o.num_update = nu
            o._index_update_count.clear()
            o._index_update_count.update(counts)
            o.lr_scheduler = copy.deepcopy(sched)
            hc = getattr(u, "hyper_cache", None)
            if hc is None:
                continue
            for k in list(hc._ts):
                if k in ts:
                    hc._ts[k] = (hc._ts[k][0], ts[k])
                else:
                    # made after the snapshot: seeded again from the counts
                    del hc._ts[k]

    @property
    def _snapshot_calls(self) -> int:
        return -(-self.snapshot_steps // self.steps_per_call)

    def _maybe_snapshot(self) -> None:
        due = self._snap is None \
            or self._step_count % self._snapshot_calls == 0
        if not due or not self._can_restore:
            return
        if self._snap is not None and self._snap.step == self._step_count:
            return  # a retry re-entering the same boundary
        from .parameter import DeferredInitializationError
        try:
            tensors, opts, _ = self._live_state()
        except DeferredInitializationError:
            return  # shapes materialize on the first forward
        live = OrderedDict()
        host_vals = {}
        for name, (v, _drop) in tensors.items():
            if isinstance(v, torch.Tensor):
                live[name] = v
            else:
                host_vals[name] = copy.deepcopy(v)
        snap = self._snap_buffers
        dt = snap.capture(live, (self._host_counts(opts), host_vals),
                          self._step_count)
        self.snapshot_seconds.append(dt)
        self._snap = snap
        self._window.clear()
        if _metrics.ENABLED:
            _metrics.SUPERVISOR_SNAPSHOTS.inc()
            _metrics.SUPERVISOR_LAST_SNAPSHOT_STEP.set(self._step_count)

    def _restore_snapshot(self) -> None:
        assert self._snap is not None
        t0 = time.perf_counter()
        snap = self._snap
        counts, host_vals = snap.host
        if self._restore_fn is not None:
            snap.host_ready()
            state = {n: b.clone() for n, b in snap.bufs.items()}
            state.update(copy.deepcopy(host_vals))
            self._restore_fn(state)
            self.last_restore = {"in_place": False,
                                 "why": "restore_fn replaces the state"}
            self.restore_seconds.append(time.perf_counter() - t0)
            return
        tensors, opts, after = self._live_state()
        missing = [n for n in snap.names if n not in tensors]
        if missing:
            raise MXNetError(
                f"snapshot holds {missing[:3]} that the live state lacks — "
                "the model or its trainer changed after the snapshot")
        dropped = []
        snap.wait_stream()
        with torch.no_grad():
            for name, (t, drop) in tensors.items():
                buf = snap.bufs.get(name)
                if buf is None:
                    if drop is None:
                        raise MXNetError(
                            f"snapshot lacks {name!r} — the parameters "
                            "changed after the supervisor captured them")
                    drop()
                    dropped.append(name)
                    continue
                if buf.shape != t.shape or buf.dtype != t.dtype:
                    raise MXNetError(
                        f"snapshot of {name!r} is {tuple(buf.shape)} "
                        f"{buf.dtype}, the live tensor {tuple(t.shape)} "
                        f"{t.dtype}")
                t.copy_(buf, non_blocking=t.is_cuda)
        # optimizer states created after the snapshot: the next step makes
        # them afresh, as the snapshot's step did
        self._set_host_counts(opts, counts)
        if after is not None:
            after()
        why = None
        if dropped:
            why = (f"{len(dropped)} tensors were created after the "
                   f"snapshot ({', '.join(dropped[:3])}"
                   f"{', ...' if len(dropped) > 3 else ''}): they are "
                   "dropped and made afresh by the next step, whose new "
                   "storage a captured step graph captures again")
            log.warning("supervisor: restore could not write everything in "
                        "place — %s", why)
        self.last_restore = {"in_place": not dropped, "why": why}
        self.restore_seconds.append(time.perf_counter() - t0)

    def _drain(self) -> None:
        """Wait for the card's copies and replayed steps (on the current
        stream), so that a replay scope's time is their time; on the
        recovery path only."""
        if self._snap is not None and self._snap.event is not None:
            torch.cuda.current_stream().synchronize()

    # -- retry loop ----------------------------------------------------------
    def _attempt(self, args, kw):
        delay = self.backoff_s
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                if attempt:
                    time.sleep(delay)
                    delay *= 2
                    self._rewind_for_retry()
                return self._execute(args, kw)
            except (DivergenceError, TrainingStalledError):
                raise
            except BaseException as e:  # noqa: BLE001 — classify decides
                kind = _res.classify(e)
                if kind is not _res.TRANSIENT:
                    raise
                if not self._can_restore:
                    if not self._retry_warned:
                        log.warning(
                            "supervisor has no snapshot surface (no "
                            "trainer/params/restore_fn) — transient step "
                            "failures propagate instead of retrying")
                        self._retry_warned = True
                    raise
                last = e
                if attempt == self.retries:
                    raise StepRetriesExhausted(
                        f"step {self._step_count} failed "
                        f"{self.retries + 1} times on transient errors "
                        f"(last: {type(e).__name__}: {e})",
                        step=self._step_count) from e
                if _metrics.ENABLED:
                    _metrics.SUPERVISOR_RETRIES.inc()
                if _journal.ENABLED:
                    _journal.emit("supervisor_retry",
                                  step=self._step_count,
                                  attempt=attempt + 1,
                                  error=f"{type(e).__name__}: {e}")
                log.warning(
                    "supervisor: transient failure at step %d "
                    "(%s: %s) — restoring snapshot from step %s and "
                    "retrying (%d/%d)", self._step_count,
                    type(e).__name__, e,
                    self._snap.step if self._snap else None,
                    attempt + 1, self.retries)
        raise StepRetriesExhausted(  # pragma: no cover — loop invariant
            f"step {self._step_count}", step=self._step_count) from last

    def _rewind_for_retry(self) -> None:
        """Restore the last snapshot and replay the batch window up to
        (but not including) the failed step."""
        if self._snap is None:
            # a transient on the FIRST step before any snapshot (deferred
            # shapes): the wired fault sites fire before any mutation, so
            # the live state is the state the step started from
            cur = self._window[-1] if self._window else None
            log.warning(
                "supervisor: first-step transient with no snapshot — "
                "capturing the post-attempt live state as the restore "
                "point (the wired fault sites fire before any mutation)")
            self._maybe_snapshot()
            if self._snap is None:
                raise MXNetError(
                    "supervisor retry without a snapshot — parameters "
                    "are still deferred-initialized after the failed "
                    "attempt")
            if cur is not None and not self._window:
                self._window.append(cur)
            return
        if _metrics.ENABLED:
            _metrics.SUPERVISOR_REWINDS.inc(reason="retry")
        # the restore + window replay is re-done work, not progress: its
        # wall-clock books as retry_replay badput
        with _goodput.replay_scope("retry_replay"):
            self._restore_snapshot()
            for rargs, rkw in self._window[:-1]:
                self._execute(rargs, rkw)
            self._drain()

    # -- stall-guarded execution ---------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._work_q = _queue.SimpleQueue()
        self._result_q = _queue.SimpleQueue()
        self._worker = threading.Thread(
            target=self._worker_loop, name="mxt-supervisor-step",
            daemon=True)
        self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            job = self._work_q.get()
            if job is None:
                return
            fn, args, kw, dev, stream = job
            try:
                if stream is not None:
                    # torch's current device and stream are per thread:
                    # run on the caller's
                    torch.cuda.set_device(dev)
                    with torch.cuda.stream(stream):
                        out = fn(*args, **kw)
                else:
                    out = fn(*args, **kw)
                self._result_q.put(("ok", out))
            except BaseException as e:  # noqa: BLE001 — carried to caller
                self._result_q.put(("err", e))

    def _stall_timeout(self) -> Optional[float]:
        """``stall_factor`` x the warmed EWMA, floored at ``stall_min_s``;
        None (wait forever) until this supervisor's own measurements warm
        (the first steps include captures).  The flight recorder's
        ``trainer_step``/``whole_step`` EWMAs can only raise it."""
        if self._ewma_n < _EWMA_WARMUP:
            return None
        ewma = self._ewma
        for phase in _STEP_PHASES:
            fe = _flight.watch_ewma(phase) if _flight.ENABLED else None
            if fe is not None and fe > ewma:
                ewma = fe
        return max(self.stall_min_s, self.stall_factor * ewma)

    def _execute(self, args, kw):
        t0 = time.perf_counter()
        self._in_step = True
        if self._snap is not None:
            self._snap.wait_stream()
        try:
            if self.stall_factor <= 0:
                status, payload = "ok", self._step_fn(*args, **kw)
            else:
                self._ensure_worker()
                dev = stream = None
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    dev = torch.cuda.current_device()
                    stream = torch.cuda.current_stream(dev)
                timeout = self._stall_timeout()
                self._work_q.put((self._step_fn, args, kw, dev, stream))
                try:
                    status, payload = self._result_q.get(timeout=timeout)
                except _queue.Empty:
                    self._on_stall(timeout)
        finally:
            self._in_step = False
        dur = time.perf_counter() - t0
        self._ewma = dur if self._ewma_n == 0 else \
            _EWMA_ALPHA * dur + (1.0 - _EWMA_ALPHA) * self._ewma
        self._ewma_n += 1
        if status == "err":
            raise payload
        return payload

    def _on_stall(self, timeout: float):
        self._stalled = (f"step {self._step_count} exceeded "
                         f"{timeout:.1f}s")
        if _metrics.ENABLED:
            _metrics.SUPERVISOR_WATCHDOG_TRIPS.inc(kind="stall")
        report = _res.post_mortem(
            "stall", step=self._step_count,
            detail={"timeout_s": round(timeout, 3),
                    "ewma_s": round(self._ewma, 6),
                    "stall_factor": self.stall_factor})
        if _goodput.ENABLED:
            _goodput.attribute("stall", timeout)
        if _journal.ENABLED:
            _journal.emit("supervisor_stall", step=self._step_count,
                          durable=True, timeout_s=round(timeout, 3),
                          report_path=(report or {}).get("report_path"),
                          flight_path=(report or {}).get("flight_path"))
        raise TrainingStalledError(
            f"training step {self._step_count} still running after "
            f"{timeout:.1f}s (EWMA {self._ewma * 1e3:.1f} ms x factor "
            f"{self.stall_factor:g}, floor {self.stall_min_s:g}s) — "
            "device presumed wedged; post-mortem "
            f"{(report or {}).get('report_path')}",
            step=self._step_count, timeout_s=timeout, report=report)

    # -- divergence watchdog -------------------------------------------------
    def _check_divergence(self, out):
        if self.check_every < 1 or \
                self._step_count % self.check_every != 0:
            return out
        if _finite(out):
            self._nonfinite = 0
            return out
        self._nonfinite += 1
        if self._nonfinite < self.diverge_patience:
            return out
        failing = self._step_count - 1  # the step just completed
        if _metrics.ENABLED:
            _metrics.SUPERVISOR_WATCHDOG_TRIPS.inc(kind="divergence")
        report = _res.post_mortem(
            "divergence", step=failing,
            detail={"consecutive_nonfinite": self._nonfinite,
                    "patience": self.diverge_patience})
        if _journal.ENABLED:
            _journal.emit("supervisor_divergence", step=failing,
                          durable=True, action=self.on_diverge,
                          report_path=(report or {}).get("report_path"),
                          flight_path=(report or {}).get("flight_path"))
        self._nonfinite = 0
        if self.on_diverge == "rewind" and self._snap is not None \
                and self._can_restore:
            if _metrics.ENABLED:
                _metrics.SUPERVISOR_REWINDS.inc(reason="divergence")
            log.warning(
                "supervisor: divergence at step %d — rewinding to the "
                "snapshot from step %d (MXNET_SUPERVISE_ON_DIVERGE="
                "rewind); post-mortem %s", failing, self._snap.step,
                (report or {}).get("report_path"))
            with _goodput.replay_scope("rewind"):
                self._restore_snapshot()
                self._drain()
            # the window's batches produced the divergence: not replayed
            self._window.clear()
            return out
        raise DivergenceError(
            f"loss was nonfinite for {self.diverge_patience} consecutive "
            f"checked steps (last: step {failing}) — post-mortem "
            f"{(report or {}).get('report_path')}",
            step=failing, report=report)

    # -- preemption ----------------------------------------------------------
    def _snapshot_state_dict(self) -> dict:
        """The last snapshot in ``save_trainer`` key packing (parameters
        as host tensors, the trainer's states as its state-file bytes,
        built from the snapshot's host copies)."""
        snap = self._snap
        snap.host_ready()
        counts, host_vals = snap.host
        if self._state_fn is not None or self._snapshot_fn is not None:
            out = {n: b.clone() for n, b in snap.bufs.items()}
            out.update(host_vals)
            return out
        from ..checkpoint.manager import PARAM_PREFIX, TRAINER_STATES_KEY
        from ..ndarray import ndarray as _nd
        out = {f"{PARAM_PREFIX}{n[len('param:'):]}": b.clone()
               for n, b in snap.bufs.items() if n.startswith("param:")}
        tr = self._trainer
        if tr is not None:
            upd = tr._state_updater()
            states = {}
            for k, st in upd.states.items():
                states[k] = _rebuild(st, snap.bufs, f"state:{k!r}")
            opt_ = copy.copy(upd.optimizer)
            nu, cnt, sched, _ts = counts[0]
            opt_.num_update = nu
            opt_._index_update_count = dict(cnt)
            opt_.lr_scheduler = copy.deepcopy(sched)
            out[TRAINER_STATES_KEY] = _nd.dumps((states, opt_))
        return out

    def install_preemption_hook(self, manager, **kw) -> Callable[[], None]:
        """The SIGTERM hook, fired through the supervisor: the emergency
        save uses the last snapshot when the signal lands MID-STEP (the
        live tensors may be half-updated) and a fresh pack otherwise.
        State is saved in ``save_trainer`` key packing, so
        ``restore_trainer``/``restore_or_initialize`` resume it.  Returns
        the uninstaller."""
        from ..checkpoint.hooks import install_preemption_hook

        def state_fn():
            if self._in_step and self._snap is not None:
                return self._snap.step, self._snapshot_state_dict()
            if self._in_step:
                log.warning("preemption landed mid-step with no snapshot "
                            "yet — saving live state (may be mid-update)")
            return self._step_count, self._pack_live_state()

        return install_preemption_hook(manager, state_fn, **kw)

    def _pack_live_state(self) -> dict:
        if self._snapshot_fn is not None:
            return self._snapshot_fn()
        if self._state_fn is not None:
            tensors, _, _ = self._state_fn()
            return {n: t for n, (t, _d) in tensors.items()}
        from ..checkpoint.manager import PARAM_PREFIX, TRAINER_STATES_KEY
        state: dict = {}
        if self._pd is not None:
            state.update({f"{PARAM_PREFIX}{name}": p.data()
                          for name, p in self._pd.items()})
        if self._trainer is not None:
            state[TRAINER_STATES_KEY] = self._trainer.get_states_bytes()
        return state

    # -- lifecycle -----------------------------------------------------------
    @property
    def stalled(self) -> Optional[str]:
        """Poison reason after a stall (None = healthy)."""
        return self._stalled

    def stats(self) -> dict:
        return {
            "enabled": ENABLED,
            "steps": self._step_count,
            "snapshot_step": self._snap.step if self._snap else None,
            "snapshot_bytes": self._snap.nbytes if self._snap else 0,
            "window": len(self._window),
            "nonfinite_streak": self._nonfinite,
            "stalled": self._stalled,
            "ewma_ms": round(self._ewma * 1e3, 3),
            "last_restore": self.last_restore,
        }

    def close(self) -> None:
        """Stop the step executor thread (idempotent).  A poisoned
        (stalled) supervisor's worker is left behind on purpose — it is
        blocked inside the wedged step."""
        w, q = self._worker, self._work_q
        self._worker = None
        if w is None or not w.is_alive():
            return
        if self._stalled is None and q is not None:
            q.put(None)
            w.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def _updater_tensors(upd, prefix, tensors) -> None:
    """Add an updater's state tensors, ``{prefix}:{key!r}:{j}``, each with
    a drop that removes its key's state (made afresh by the next step), and
    the device step counters of its captured steps (``HyperDeviceCache``)."""
    for k, st in list(upd.states.items()):
        def drop(upd=upd, k=k):
            upd.states.pop(k, None)
            upd.states_synced.pop(k, None)
        for j, t in enumerate(_leaves(st)):
            tensors[f"{prefix}:{k!r}:{j}"] = (t, drop)
    hc = getattr(upd, "hyper_cache", None)
    if hc is not None:
        for j, (key, (t, _rec)) in enumerate(list(hc._ts.items())):
            def drop_t(hc=hc, key=key):
                hc._ts.pop(key, None)
            tensors[f"{prefix}:t:{key!r}"] = (t, drop_t)


def _rebuild(state, bufs, name):
    """An optimizer state's structure with host snapshot copies at its
    tensor leaves (for the emergency save)."""
    it = itertools.count()

    def walk(s):
        if s is None:
            return None
        if isinstance(s, torch.Tensor):
            return bufs[f"{name}:{next(it)}"].clone()
        if isinstance(s, (list, tuple)):
            return type(s)(walk(x) for x in s)
        return s
    return walk(state)
