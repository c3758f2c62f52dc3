"""Dynamic micro-batching for the serving fast path.

The counterpart of ``mxnet_tpu/serving/batcher.py``.  Steady-state serving
traffic is many small concurrent requests, and each one dispatched alone
wastes the card (a forward at batch 1 takes about as long as at batch 4).
The micro-batcher is the standard serving answer (TF-Serving's
BatchingSession shape): a request queue plus one dispatcher thread that
coalesces whatever arrived within ``max_wait_ms`` (or until ``max_batch``
rows) into one padded bucket dispatch, then scatters the output rows back
to the callers' futures.

Latency contract: a lone request waits at most ``max_wait_ms`` beyond its
own dispatch; under load the queue drains continuously and the wait
converges to zero (the previous dispatch is the wait).

Each request carries a flight-recorder trace id from submit through its
queue wait, the stacking and the dispatch (``serve_submit``,
``serve_queue_wait``, ``serve_stack`` records, joinable across the
threads in a dump), and its end-to-end latency feeds the slow-request
watchdog.  The ``serving.batcher`` fault site fires before each group
dispatch: a raise there kills the worker, whose futures then fail typed.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as _np

from ..autotune import decisions as _decisions
from ..base import MXNetError, getenv
from ..faultinject import fire as _fi_fire
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from .buckets import covering_bucket, pad_to_shape

__all__ = ["MicroBatcher", "BatcherClosedError", "BatcherDeadError",
           "GenerativeRouteError", "stack_requests"]


class GenerativeRouteError(MXNetError):
    """A generative (multi-token decode) request reached the
    request-coalescing tier.  Refused LOUDLY by design: one long
    generation would pin its whole coalesced micro-batch group for its
    full output length.  Generation belongs to a decode engine that
    admits and retires sequences per decode step
    (`serving.decode.DecodeEngine`) or to `TransformerLM.generate`."""


class BatcherClosedError(MXNetError):
    """The batcher/server was closed before this request could be
    dispatched (or before it could be submitted)."""


class BatcherDeadError(MXNetError):
    """The dispatcher thread died.  Every pending future is failed with
    this — a dead worker must surface as a typed error, never as a
    caller hanging in Future.result() forever."""


def record_group_queue_wait(group, t_dispatch_us: float) -> None:
    """Flight-record each request's queue wait (submit to dispatch start)
    under its own trace id; shared by ``MicroBatcher`` and
    ``ResilientServer``."""
    for r in group:
        _flight.record("serve_queue_wait", "serving", r.t0 * 1e6,
                       t_dispatch_us, trace_id=r.trace_id)


def group_trace_scope(group):
    """The thread-local trace scope of a group: its members' ids joined,
    so the spans recorded inside join against every member."""
    return _flight.trace_scope(
        _flight.join_ids([r.trace_id for r in group]))


class _Request:
    __slots__ = ("inputs", "rows", "future", "t0", "trace_id")

    def __init__(self, inputs: Dict[str, _np.ndarray]):
        self.inputs = inputs
        self.rows = next(iter(inputs.values())).shape[0]
        self.future: Future = Future()
        self.t0 = time.perf_counter()
        # the flight-recorder request id, minted here and carried through
        # queue wait, stacking and dispatch
        self.trace_id = _flight.new_trace_id() if _flight.ENABLED \
            else None


def stack_requests(spec, group) -> Dict[str, _np.ndarray]:
    """Stack a group of validated requests into one rectangular batch.
    Per-request sequence lengths may differ: each request pads up to the
    group's covering seq bucket BEFORE stacking (host-side copies; the
    device still sees one transfer + one dispatch).  Shared by
    `MicroBatcher` and `ResilientServer` — any object with `.inputs`
    dicts of equal key sets works."""
    names = list(group[0].inputs)
    stacked = {}
    for n in names:
        parts = [r.inputs[n] for r in group]
        ax = spec.seq_axes.get(n)
        if ax is not None and len({p.shape[ax] for p in parts}) > 1:
            tgt = covering_bucket(spec.seq_buckets,
                                  max(p.shape[ax] for p in parts))
            parts = [pad_to_shape(
                p, p.shape[:ax] + (tgt,) + p.shape[ax + 1:])
                for p in parts]
        stacked[n] = parts[0] if len(parts) == 1 else \
            _np.concatenate(parts, axis=0)
    return stacked


class MicroBatcher:
    """Coalesces concurrent `submit()`s into bucket-sized dispatches.

    Parameters
    ----------
    predictor : BucketedPredictor
        The bucketed serving executor requests are routed through.
    max_wait_ms : float
        How long the dispatcher holds an open batch for more arrivals
        (default `MXNET_SERVE_MAX_WAIT_MS`, 2 ms).  0 disables
        coalescing-by-time: each drain takes only what already queued.
    max_batch : int
        Row cap per coalesced dispatch (default `MXNET_SERVE_MAX_BATCH`,
        else the predictor's largest batch bucket).
    """

    def __init__(self, predictor, max_wait_ms: Optional[float] = None,
                 max_batch: Optional[int] = None):
        self._pred = predictor
        if max_wait_ms is None:
            # ctor arg > MXNET_SERVE_MAX_WAIT_MS env pin > the persisted
            # decision (from the dispatch EWMA) > 2 ms
            decided = None
            if "MXNET_SERVE_MAX_WAIT_MS" not in os.environ \
                    and _decisions.ENABLED:
                sig = getattr(getattr(predictor, "spec", None),
                              "signature", None)
                if sig is not None:
                    decided = _decisions.knob(sig, "serve_max_wait_ms",
                                              None)
            max_wait_ms = getenv("MXNET_SERVE_MAX_WAIT_MS", 2.0) \
                if decided is None else float(decided)
        self._max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        # the default chain: ctor arg > MXNET_SERVE_MAX_BATCH > largest
        # bucket
        if max_batch is None:
            max_batch = getenv("MXNET_SERVE_MAX_BATCH",
                               int(predictor.spec.max_batch))
        self._max_batch = int(max_batch)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: _Request = None  # displaced overflow, leads next group
        # guards the pending slot: the dispatcher writes it while
        # close(timeout) (after a timed-out join) and _die() must be
        # able to claim it and fail its future instead of leaving the
        # caller hanging
        self._pending_lock = threading.Lock()
        self._closed = False
        # set (under _pending_lock) once close() has swept the pending
        # slot: from then on the dispatcher must fail a displaced
        # request itself — parking it would orphan it.  Before the
        # sweep, parking during a graceful close is correct: the
        # dispatcher drains the slot before exiting
        self._swept = False
        self._fatal: Exception = None  # dispatcher-death cause
        # serializes the closed-check+enqueue against close(): without
        # it a submit() could enqueue after close() drained, leaving its
        # future unresolved forever.  Lock order: submit -> pending, never
        # the reverse
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name="mxnet-serve-batcher", daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def submit(self, max_new_tokens: Optional[int] = None,
               **inputs) -> Future:
        """Enqueue one request; resolves to the list of output arrays
        (rows matching this request).  Never blocks on model execution:
        oversized requests ride the dispatcher thread too (dispatched
        alone; predict() chunks them over the largest bucket).  A
        malformed request fails ITS OWN future at enqueue time — it is
        never coalesced, so it cannot poison a group of well-formed
        requests that arrived in the same wait window.

        Output-shape note (seq-bucketed models): outputs come back at
        the dispatched bucket's width — for a coalesced group that is
        the GROUP's covering seq bucket, which may exceed the bucket
        the same request would route to solo.  Consumers slice by their
        request's true sequence length (valid-region values agree either
        way)."""
        if max_new_tokens is not None:
            # raised in the CALLER's thread, not failed on the future:
            # this is a routing bug at the call site, and the hostage
            # path it would reintroduce (regression-pinned in
            # tests/test_decode.py) must never be one silent drop away
            raise GenerativeRouteError(
                f"max_new_tokens={max_new_tokens}: generative decode "
                f"must not ride the request-coalescing micro-batcher — "
                f"one long sequence would hold its whole coalesced "
                f"group hostage.  Use serving.decode.DecodeEngine "
                f"(per-step join/leave) or BucketingModule.generate")
        try:
            # normalization can fail too (unknown input name, empty
            # request) — every malformed-request shape must land on the
            # returned future as a descriptive MXNetError, never escape
            # as a raw KeyError in the caller's thread
            self._pred._check_names(inputs)
            req = _Request({n: self._pred._as_host(n, v)
                            for n, v in inputs.items()})
            self._pred._check_request(req.inputs)
            if _flight.ENABLED:
                # the caller-thread anchor of the request's trace id
                _flight.record("serve_submit", "serving", req.t0 * 1e6,
                               _flight.now_us(), trace_id=req.trace_id)
        except Exception as e:  # noqa: BLE001 — delivered to caller
            f = Future()
            f.set_exception(e)
            return f
        with self._submit_lock:
            # atomic closed-check + enqueue: anything enqueued here is
            # ahead of close()'s sentinel, so the dispatcher serves it
            # (and _die() drains under the same lock, so nothing can
            # slip into the queue after a dead worker's final sweep)
            if self._closed:
                raise BatcherClosedError("MicroBatcher is closed")
            if self._fatal is not None:
                raise BatcherDeadError(
                    f"MicroBatcher worker died: {self._fatal}")
            self._queue.put(req)
        if _metrics.ENABLED:
            _metrics.SERVE_QUEUE_DEPTH.set(self._queue.qsize())
        return req.future

    def predict(self, **inputs) -> List[_np.ndarray]:
        """Blocking submit — the drop-in replacement for
        `predictor.predict` that rides the coalesced path."""
        return self.submit(**inputs).result()

    def close(self, timeout: float = 5.0) -> None:
        """Drain and stop the dispatcher thread.  Requests still queued
        (or displaced into the pending slot) when the worker exits — or
        when the join times out because a dispatch is hung — fail with a
        typed ``BatcherClosedError`` instead of hanging their caller's
        ``Future.result()`` forever; later ``submit()``s raise
        immediately."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # wake the dispatcher
        self._thread.join(timeout)
        alive = self._thread.is_alive()  # join timed out mid-dispatch
        leftovers = []
        with self._pending_lock:
            # the slot lock makes the claim safe even while the
            # dispatcher is alive mid-dispatch: it fails (rather than
            # parks) displaced requests once _swept is set
            self._swept = True
            if self._pending is not None:
                leftovers.append(self._pending)
                self._pending = None
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        if alive:
            # the drain above may have eaten the close sentinel; re-arm
            # it so the still-running dispatcher exits instead of
            # blocking in queue.get() forever when its dispatch ends
            self._queue.put(None)
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(
                    BatcherClosedError("MicroBatcher closed before "
                                       "dispatch"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher side -----------------------------------------------------
    def _take_group(self) -> Optional[List[_Request]]:
        """Block for the first request, then hold the batch open until
        max_wait elapses or max_batch rows have arrived."""
        with self._pending_lock:
            first, self._pending = self._pending, None
        if first is None:
            first = self._queue.get()
            if first is None:
                return None
        group, rows = [first], first.rows
        deadline = time.perf_counter() + self._max_wait_s
        while rows < self._max_batch:
            remaining = deadline - time.perf_counter()
            try:
                nxt = self._queue.get(
                    timeout=remaining if remaining > 0 else None,
                    block=remaining > 0)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the close sentinel
                break
            if rows + nxt.rows > self._max_batch:
                # would overflow the largest bucket: dispatch what we
                # have; hold the displaced request in the pending slot so
                # it LEADS the next group (re-queueing would push it to
                # the FIFO tail, starving large requests behind a steady
                # stream of small ones)
                with self._pending_lock:
                    if self._swept:
                        # close() already swept the slot: fail the
                        # displaced request now, or nobody ever will
                        # (a merely-closing batcher still drains — a
                        # request enqueued before close() is served)
                        if not nxt.future.done():
                            nxt.future.set_exception(BatcherClosedError(
                                "MicroBatcher closed before dispatch"))
                    else:
                        self._pending = nxt
                break
            group.append(nxt)
            rows += nxt.rows
        if _metrics.ENABLED:
            _metrics.SERVE_QUEUE_DEPTH.set(self._queue.qsize())
        return group

    def _dispatch_group(self, group: List[_Request]) -> None:
        fl = _flight.ENABLED
        if fl:
            record_group_queue_wait(group, _flight.now_us())
        try:
            with group_trace_scope(group):
                with _flight.phase_span("serve_stack", cat="serving"):
                    stacked = stack_requests(self._pred.spec, group)
                # the routed private path: request accounting happens
                # here, per caller (predict() would count the stacked
                # batch as one request and fold queue wait out of the
                # latency histogram)
                outs = self._pred._predict_routed(stacked)
            lo = 0
            for r in group:
                # done() guard: close(timeout) may have already failed
                # this future while a long dispatch overran the join
                if not r.future.done():
                    r.future.set_result(
                        [o[lo:lo + r.rows] for o in outs])
                lo += r.rows
            now = time.perf_counter()
            if _metrics.ENABLED:
                _metrics.SERVE_REQUESTS.inc(len(group))
                for r in group:
                    _metrics.SERVE_LATENCY_SECONDS.observe(
                        now - r.t0, exemplar=r.trace_id)
                _metrics.SERVE_COALESCED_ROWS.set(
                    sum(r.rows for r in group))
            if fl:
                # the slow-request watchdog: end-to-end latency vs EWMA
                for r in group:
                    _flight.note("serve_request", now - r.t0)
        except Exception as e:  # noqa: BLE001 — failures go to callers
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)

    def _loop(self) -> None:
        group = None
        try:
            while True:
                group = self._take_group()
                if group is None:
                    return
                # a raise rule here kills the worker: every in-flight and
                # queued future must then fail typed, never hang
                _fi_fire("serving.batcher")
                self._dispatch_group(group)
                group = None
                if self._closed and self._queue.empty() \
                        and self._pending is None:
                    return
        except BaseException as e:  # noqa: BLE001 — worker death
            # swallow after cleanup: the cause is recorded in _fatal
            # (submit raises it), every future failed typed, and the
            # thread exits — re-raising would only spam the thread
            # excepthook
            self._die(e, group)
            logging.getLogger(__name__).error(
                "MicroBatcher worker died: %r", e)

    def _die(self, exc: BaseException, group) -> None:
        """Dispatcher-death cleanup: record the cause (submit() raises
        it from now on), then fail the current group plus everything
        queued/pending.  Runs under _submit_lock so no submit() can
        slip a request into the queue after the final sweep."""
        err = BatcherDeadError(
            f"MicroBatcher worker died: {type(exc).__name__}: {exc}")
        reqs = list(group or [])
        with self._submit_lock:
            self._fatal = exc if isinstance(exc, Exception) \
                else RuntimeError(repr(exc))
            with self._pending_lock:
                if self._pending is not None:
                    reqs.append(self._pending)
                    self._pending = None
            while True:
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    break
                if r is not None:
                    reqs.append(r)
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(err)
