"""Serving resilience tier: admission control, deadline-aware load
shedding, health/readiness.

The counterpart of ``mxnet_tpu/serving/resilience.py``: the layer above
``BucketedPredictor`` that keeps a replica at bounded p99 plus typed
rejections under overload instead of tail-latency collapse (the
TF-Serving / SRE shape, arxiv 1605.08695):

  * **admission control** — bounded per-tenant priority queues; a full
    queue rejects with a typed ``Overloaded`` carrying a retry-after hint
    (``MXNET_SERVE_MAX_QUEUE``).
  * **load shedding** — with ``MXNET_SERVE_SHED_POLICY=deadline``
    (default) a request whose deadline the estimated wait already cannot
    meet is shed at submit.
  * **deadline-aware scheduling** — the dispatcher pops highest priority,
    earliest deadline first (round-robin across tenants) and drops
    already-expired work before padding/dispatch (typed
    ``DeadlineExceeded``; ``expired_dispatches`` stays at zero).
  * **health/readiness** — ``healthz()`` (liveness) and ``readyz()``
    (warmup complete, dispatch latency / failure rate / stall within
    thresholds), evaluated by a watchdog thread and published through
    the metrics registry (``mxnet_serve_ready``,
    ``mxnet_serve_ready_transitions_total``).

Goodput: a shed admission counts a ``shed`` event, an expired request
books its queue wait as ``shed`` seconds, and each served latency feeds
the serve-p99 SLO monitor (``MXNET_SLO_SERVE_P99_MS``; ``readyz`` gains
an ``slo_burn`` check when an SLO is declared).  Each request carries a
flight-recorder trace id through its queue wait and stacking, and its
latency feeds the slow-request watchdog.

A ``ModelRegistry`` hooks each model's server: ``extra_ready`` merges its
degradation rung into ``readyz``, ``oom_retry`` is the OOM second chance
(a dispatch that runs out of device memory asks the registry to evict and
runs once more), and ``pending()`` is its is-this-model-idle question.
``StepEDF`` is the decode-step deadline estimator ``DecodeEngine`` feeds.
A perf regression the introspector's sentinel holds fails the
``perf_regression`` check.

Not ported: the memory-budget readiness check and the compile-cache
readiness check (there is no persistent compile cache).
"""
from __future__ import annotations

import heapq
import itertools
import logging
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as _np

from ..base import MXNetError, getenv
from ..observability import flight as _flight
from ..observability import goodput as _goodput
from ..observability import memory as _memory
from ..observability import metrics as _metrics
from .batcher import (BatcherClosedError, BatcherDeadError,
                      GenerativeRouteError, group_trace_scope,
                      record_group_queue_wait, stack_requests)

log = logging.getLogger(__name__)

__all__ = ["Overloaded", "DeadlineExceeded", "ResilientServer",
           "SHED_POLICIES", "StepEDF"]

SHED_POLICIES = ("depth", "deadline")


class Overloaded(MXNetError):
    """Request rejected by admission control (reject-with-backpressure).

    ``retry_after_s`` is the server's estimate of when capacity frees
    up — an RPC front end maps it to ``Retry-After`` so well-behaved
    clients back off instead of hammering a saturated replica."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(MXNetError):
    """An admitted request's deadline passed while it waited in queue.
    The work was dropped BEFORE padding/dispatch — the accelerator
    never burns a cycle on an answer nobody is waiting for."""


class StepEDF:
    """Earliest-deadline-first estimate at decode-step granularity (parity:
    ``mxnet_tpu/serving/resilience.py:StepEDF``).

    A generation costs remaining tokens x seconds per step.
    ``DecodeEngine`` feeds every step's wall-clock into the EWMA and asks,
    at admission, whether a deadline clears the ETA behind the queued token
    backlog and, between steps, whether an in-flight sequence's remaining
    tokens still fit (``unmeetable``)."""

    #: the prior before any observation; the EWMA converges in ~10 steps
    PRIOR_S = 0.01

    def __init__(self, alpha: float = 0.2):
        self._alpha = float(alpha)
        self._ewma: Optional[float] = None

    def observe(self, step_s: float) -> None:
        step_s = max(0.0, float(step_s))
        self._ewma = step_s if self._ewma is None else \
            (1 - self._alpha) * self._ewma + self._alpha * step_s

    def step_s(self) -> float:
        return self.PRIOR_S if self._ewma is None else self._ewma

    def eta_s(self, tokens: int, lanes: int = 1) -> float:
        """Seconds to decode ``tokens`` more tokens with ``lanes`` slots
        advancing one token per step each."""
        return (max(0, int(tokens)) / max(1, int(lanes))) * self.step_s()

    def unmeetable(self, deadline: Optional[float], now: float,
                   remaining_tokens: int) -> bool:
        """True when ``remaining_tokens`` more steps cannot finish before
        ``deadline`` (absolute perf_counter time; None: no deadline)."""
        if deadline is None:
            return False
        return now + self.eta_s(remaining_tokens) > deadline


class _Request:
    __slots__ = ("inputs", "rows", "future", "tenant", "tref",
                 "priority", "deadline", "t0", "trace_id")

    def __init__(self, inputs, tenant: str, priority: int,
                 deadline: Optional[float]):
        self.inputs = inputs
        self.rows = next(iter(inputs.values())).shape[0]
        self.future: Future = Future()
        self.tenant = tenant
        # direct _Tenant reference (set at admission): accounting after
        # pop must not look the name up again — idle-tenant eviction
        # may have removed it from the table by then
        self.tref: Optional["_Tenant"] = None
        self.priority = int(priority)
        self.deadline = deadline  # absolute perf_counter time, or None
        self.t0 = time.perf_counter()
        self.trace_id = _flight.new_trace_id() if _flight.ENABLED \
            else None


class _Tenant:
    __slots__ = ("name", "heap", "rows_queued", "admitted", "served",
                 "expired", "shed")

    def __init__(self, name: str):
        self.name = name
        # entries: (-priority, deadline_or_inf, seq, request) — pops
        # highest priority first, earliest deadline within a priority
        self.heap: List[Tuple] = []
        self.rows_queued = 0
        self.admitted = 0
        self.served = 0
        self.expired = 0
        self.shed = 0


class ResilientServer:
    """Admission-controlled, deadline-aware front for a
    ``BucketedPredictor``.

    Parameters
    ----------
    predictor : BucketedPredictor
        The bucketed serving executor requests route through.
    max_queue : int
        Per-tenant bound on queued requests (default
        ``MXNET_SERVE_MAX_QUEUE``, 64).  The hard backpressure line:
        beyond it ``submit`` raises ``Overloaded``.
    shed_policy : str
        ``"depth"`` = only the queue bound sheds; ``"deadline"``
        (default, ``MXNET_SERVE_SHED_POLICY``) additionally sheds a
        deadlined request whose estimated wait already exceeds its
        deadline.
    max_wait_ms / max_batch : float / int
        Coalescing knobs, same semantics as ``MicroBatcher``
        (``MXNET_SERVE_MAX_WAIT_MS`` / largest batch bucket).
    unready_latency_ms : float, optional
        Watchdog threshold: dispatch-latency EWMA above this marks the
        replica unready (None/0 disables).
    unready_failure_rate : float
        Watchdog threshold on the failure fraction of the last
        ``window`` dispatches (default 0.5).
    stall_timeout_s : float
        Work queued but no dispatch completed for this long marks
        unready (a hung backend looks exactly like this).
    reload_staleness_s : float, optional
        When the predictor runs ``start_auto_reload``, an unsuccessful
        polling streak longer than this marks unready (default: 3x the
        reload interval).
    max_tenants : int
        Bound on distinct tenant names (default 256).  ``tenant`` is a
        CLIENT CLASS (service, priority tier), not a per-user id —
        every distinct name costs a queue, a round-robin slot, and
        per-tenant metric series, and admission scans are O(tenants).
        Past the bound, idle tenants (empty queue) are evicted to make
        room; if every tenant is busy the submit raises ``Overloaded``.
    """

    def __init__(self, predictor, max_queue: Optional[int] = None,
                 shed_policy: Optional[str] = None,
                 max_wait_ms: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 watchdog_interval_s: float = 0.25,
                 unready_latency_ms: Optional[float] = None,
                 unready_failure_rate: float = 0.5,
                 stall_timeout_s: float = 10.0,
                 reload_staleness_s: Optional[float] = None,
                 max_tenants: int = 256, extra_ready=None, oom_retry=None):
        self._pred = predictor
        # extra_ready: () -> (checks, detail) merged into readyz;
        # oom_retry: (DeviceMemoryError) -> bool, True when the handler
        # freed device memory and the dispatch may run once more
        self._extra_ready = extra_ready
        self._oom_retry = oom_retry
        self.max_queue = int(getenv("MXNET_SERVE_MAX_QUEUE", 64)) \
            if max_queue is None else int(max_queue)
        if self.max_queue < 1:
            raise MXNetError("max_queue must be >= 1")
        policy = shed_policy or os.environ.get(
            "MXNET_SERVE_SHED_POLICY", "").strip() or "deadline"
        if policy not in SHED_POLICIES:
            raise MXNetError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {policy!r}")
        self.shed_policy = policy
        if max_wait_ms is None:
            max_wait_ms = getenv("MXNET_SERVE_MAX_WAIT_MS", 2.0)
        self._max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        # same default chain as MicroBatcher: ctor arg >
        # MXNET_SERVE_MAX_BATCH > largest bucket
        if max_batch is None:
            max_batch = getenv("MXNET_SERVE_MAX_BATCH",
                               int(predictor.spec.max_batch))
        self._max_batch = int(max_batch)
        self.unready_latency_ms = unready_latency_ms
        self.unready_failure_rate = float(unready_failure_rate)
        self.stall_timeout_s = float(stall_timeout_s)
        self.reload_staleness_s = reload_staleness_s
        self.max_tenants = int(max_tenants)
        if self.max_tenants < 1:
            raise MXNetError("max_tenants must be >= 1")

        # lock order: cv -> metrics lock (label incs under admission);
        # ready_lock never nests inside cv
        self._cv = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}
        self._rr: List[str] = []      # tenant round-robin order
        self._rr_idx = 0
        self._seq = itertools.count()
        # admitted-but-unresolved requests (queued, being grouped in
        # the hold-open window, or in flight) — a multi-model
        # registry's is-this-model-idle signal.  Maintained by a done-callback on
        # every admitted future so served/expired/failed/closed all
        # decrement, and nothing is invisible mid-grouping the way a
        # queue+inflight snapshot would be
        self._live = 0
        self._closed = False
        self._fatal: Optional[BaseException] = None
        self._inflight: Optional[List[_Request]] = None

        # service-time model + watchdog state
        self._ewma_s = 0.0            # per-dispatch latency EWMA
        self._ewma_alpha = 0.3
        self._recent = deque(maxlen=50)   # dispatch outcomes (bool ok)
        self._last_dispatch_done: Optional[float] = None
        self._t_start = time.perf_counter()
        self._expired_dispatches = 0  # must stay 0 — the chaos invariant
        self._ready = False
        # serializes the read-compare-write on _ready between the
        # watchdog thread and readyz() callers: without it a flip could
        # double-count SERVE_READY_TRANSITIONS (the flapping signal)
        # and publish torn _ready/_last_checks state
        self._ready_lock = threading.Lock()
        self._last_checks: Dict[str, bool] = {}
        self._last_detail: dict = {}
        self._ready_reasons: List[str] = ["no_evaluation_yet"]
        if _metrics.ENABLED:
            _metrics.SERVE_READY.set(0.0)

        self._thread = threading.Thread(
            target=self._loop, name="mxt-serve-resilient", daemon=True)
        self._thread.start()
        self._watch_stop = threading.Event()
        self._watch_interval = max(0.01, float(watchdog_interval_s))
        self._watchdog = threading.Thread(
            target=self._watch, name="mxt-serve-watchdog", daemon=True)
        self._watchdog.start()

    # -- client side ---------------------------------------------------------
    def submit(self, tenant: str = "default",
               deadline_ms: Optional[float] = None, priority: int = 0,
               max_new_tokens: Optional[int] = None,
               **inputs) -> Future:
        """Enqueue one request for ``tenant``.

        Raises ``Overloaded`` synchronously when admission control
        rejects (queue full, or — under the ``deadline`` policy — the
        estimated wait already exceeds ``deadline_ms``); a malformed
        request fails its own returned future (MicroBatcher contract).
        An admitted request resolves to its output rows, or to
        ``DeadlineExceeded`` if its deadline passes before dispatch."""
        if max_new_tokens is not None:
            # same loud refusal as MicroBatcher.submit: a generation
            # here would hold a coalesced group hostage for its whole
            # output length
            raise GenerativeRouteError(
                f"max_new_tokens={max_new_tokens}: generative decode "
                f"must not ride the request-coalescing tier — use "
                f"TransformerLM.generate")
        try:
            self._pred._check_names(inputs)
            host = {n: self._pred._as_host(n, v)
                    for n, v in inputs.items()}
            self._pred._check_request(host)
        except Exception as e:  # noqa: BLE001 — delivered to caller
            f = Future()
            f.set_exception(e)
            return f
        now = time.perf_counter()
        deadline = None if deadline_ms is None \
            else now + float(deadline_ms) / 1e3
        req = _Request(host, tenant, priority, deadline)
        with self._cv:
            if self._closed:
                raise BatcherClosedError("ResilientServer is closed")
            if self._fatal is not None:
                raise BatcherDeadError(
                    f"ResilientServer worker died: {self._fatal}")
            t = self._tenant(tenant)
            if len(t.heap) >= self.max_queue:
                retry = self._estimate_wait_s(self._total_rows())
                self._shed(t, "queue_full")
                raise Overloaded(
                    f"tenant '{tenant}' queue full "
                    f"({self.max_queue} requests); retry after "
                    f"~{retry:.3f}s", retry_after_s=retry)
            if self.shed_policy == "deadline" and deadline is not None:
                # estimated wait until DISPATCH START — rows AHEAD only,
                # matching the expiry rule (a request that starts
                # dispatching before its deadline is served).  Counting
                # the request's own dispatch here would make a one-off
                # slow dispatch self-sustaining: the inflated EWMA sheds
                # every deadlined request even at an empty queue, so
                # nothing dispatches and the EWMA never recovers
                est = self._estimate_wait_s(self._total_rows())
                if now + est > deadline:
                    self._shed(t, "deadline_unmeetable")
                    raise Overloaded(
                        f"tenant '{tenant}': estimated wait "
                        f"{est * 1e3:.1f}ms exceeds deadline "
                        f"{float(deadline_ms):.1f}ms; retry after "
                        f"~{est:.3f}s", retry_after_s=est)
            req.tref = t
            heapq.heappush(t.heap, (-req.priority,
                                    deadline if deadline is not None
                                    else float("inf"),
                                    next(self._seq), req))
            t.rows_queued += req.rows
            t.admitted += 1
            self._live += 1
            req.future.add_done_callback(self._one_resolved)
            if _metrics.ENABLED:
                _metrics.SERVE_ADMITTED.inc(tenant=tenant)
                _metrics.SERVE_QUEUE_DEPTH.set(self._total_requests())
            self._cv.notify_all()
        return req.future

    def predict(self, tenant: str = "default",
                deadline_ms: Optional[float] = None, priority: int = 0,
                **inputs) -> List[_np.ndarray]:
        """Blocking submit — raises ``Overloaded`` / ``DeadlineExceeded``
        / the dispatch error in the caller's thread."""
        return self.submit(tenant=tenant, deadline_ms=deadline_ms,
                           priority=priority, **inputs).result()

    def warmup(self, keys=None) -> "ResilientServer":
        """Build and warm the predictor's buckets (each one forward on
        zeros) and refresh readiness: the replica flips ready here, before
        taking traffic."""
        self._pred.warmup(keys)
        self._update_ready()
        return self

    def close(self, timeout: float = 5.0) -> None:
        """Stop the scheduler + watchdog; fail everything still queued
        with a typed error instead of hanging callers."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        self._watch_stop.set()
        self._watchdog.join(timeout=1.0)
        leftovers = []
        with self._cv:
            for t in self._tenants.values():
                while t.heap:
                    leftovers.append(heapq.heappop(t.heap)[-1])
                t.rows_queued = 0
        err = BatcherClosedError("ResilientServer closed before dispatch")
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(err)
        # final readiness evaluation: a closed server must not keep
        # advertising ready=1 (the watchdog that
        # would have noticed is stopped now)
        self._update_ready()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- admission internals -------------------------------------------------
    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            if len(self._tenants) >= self.max_tenants:
                self._evict_idle_tenant()
            t = self._tenants[name] = _Tenant(name)
            self._rr.append(name)
        return t

    def _evict_idle_tenant(self) -> None:
        """Drop one tenant with an empty queue to cap tenant-table
        growth (high-cardinality ``tenant=`` values would otherwise
        accumulate state forever).  All-busy means genuine overload:
        reject the new tenant with backpressure.  Caller holds _cv."""
        for name, t in self._tenants.items():
            if not t.heap:
                del self._tenants[name]
                self._rr.remove(name)
                if _metrics.ENABLED:
                    # per-tenant metric series must not outlive the
                    # eviction that exists to bound tenant cardinality:
                    # counters fold into tenant="_evicted" (totals
                    # preserved), the point-in-time goodput gauge drops
                    for c in (_metrics.SERVE_ADMITTED,
                              _metrics.SERVE_SHED,
                              _metrics.SERVE_EXPIRED):
                        c.fold_label("tenant", name, "_evicted")
                    _metrics.SERVE_GOODPUT.remove(tenant=name)
                return
        retry = self._estimate_wait_s(self._total_rows())
        if _metrics.ENABLED:
            _metrics.SERVE_SHED.inc(reason="tenant_table_full")
        raise Overloaded(
            f"tenant table full ({self.max_tenants} tenants, all with "
            f"queued work); retry after ~{retry:.3f}s",
            retry_after_s=retry)

    def _total_rows(self) -> int:
        return sum(t.rows_queued for t in self._tenants.values())

    def _total_requests(self) -> int:
        return sum(len(t.heap) for t in self._tenants.values())

    def _has_work(self) -> bool:
        return any(t.heap for t in self._tenants.values())

    def _estimate_wait_s(self, rows_ahead: int) -> float:
        """Expected time until ``rows_ahead`` queued rows have cleared
        (i.e. until a newly admitted request would start dispatching):
        dispatches needed x the dispatch-latency EWMA.  Zero until the
        first dispatch lands — a cold server admits everything and lets
        the queue bound do the work."""
        if self._ewma_s <= 0.0 or rows_ahead <= 0:
            return 0.0
        return math.ceil(rows_ahead / self._max_batch) * self._ewma_s

    def _shed(self, t: _Tenant, reason: str) -> None:
        t.shed += 1
        if _metrics.ENABLED:
            _metrics.SERVE_SHED.inc(tenant=t.name, reason=reason)
        if _goodput.ENABLED:
            # a refused admission wasted no measurable wall-clock yet:
            # count the event
            _goodput.attribute("shed", 0.0)

    # -- scheduler -----------------------------------------------------------
    def _pop_into(self, group: List[_Request], expired: List[_Request],
                  cap: int) -> int:
        """Pop runnable requests round-robin across tenants (one per
        tenant per turn — fairness), highest priority / earliest
        deadline first within a tenant.  Expired heads are drained into
        ``expired`` without counting toward the row cap.  Caller holds
        the cv lock."""
        rows = sum(r.rows for r in group)
        names = self._rr
        if not names:
            return rows
        n = len(names)
        idle = 0
        while idle < n and rows < cap:
            t = self._tenants[names[self._rr_idx % n]]
            self._rr_idx += 1
            popped = False
            while t.heap:
                req = t.heap[0][-1]
                now = time.perf_counter()
                if req.deadline is not None and now >= req.deadline:
                    heapq.heappop(t.heap)
                    t.rows_queued -= req.rows
                    expired.append(req)
                    continue  # keep draining expired heads
                if group and rows + req.rows > cap:
                    break  # leave for the next group
                heapq.heappop(t.heap)
                t.rows_queued -= req.rows
                group.append(req)
                rows += req.rows
                popped = True
                break  # one pop per tenant per turn
            idle = 0 if popped else idle + 1
        return rows

    def _take_group(self):
        """Block until work or shutdown.  Returns (group, expired) or
        None when closed with nothing left."""
        expired: List[_Request] = []
        with self._cv:
            while True:
                if self._closed and not self._has_work():
                    return None
                group: List[_Request] = []
                rows = self._pop_into(group, expired, self._max_batch)
                if group:
                    # hold the batch open briefly for more arrivals
                    hold_until = time.perf_counter() + self._max_wait_s
                    while rows < self._max_batch and not self._closed:
                        remaining = hold_until - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                        rows = self._pop_into(group, expired,
                                              self._max_batch)
                    if _metrics.ENABLED:
                        _metrics.SERVE_QUEUE_DEPTH.set(
                            self._total_requests())
                    return group, expired
                if expired:
                    return group, expired  # deliver expirations promptly
                # reached only when every tenant heap is empty (a
                # non-empty heap always yields a group or an expired
                # entry above), so nothing can expire while we sleep
                # and submit()/close() notify under this lock — an
                # untimed wait costs zero idle wakeups
                self._cv.wait()

    def _expire(self, reqs: List[_Request]) -> None:
        for r in reqs:
            t = r.tref
            t.expired += 1
            if _metrics.ENABLED:
                _metrics.SERVE_EXPIRED.inc(tenant=r.tenant)
            self._publish_goodput(t)
            if not r.future.done():
                waited = (time.perf_counter() - r.t0) * 1e3
                if _goodput.ENABLED:
                    # an expired request's whole queue wait was wasted
                    _goodput.attribute("shed", waited / 1e3)
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed after {waited:.1f}ms in queue "
                    f"(tenant '{r.tenant}'); request was dropped before "
                    f"dispatch"))

    def _publish_goodput(self, t: _Tenant) -> None:
        if not _metrics.ENABLED or not t.admitted:
            return
        # membership check AND set under _cv: eviction (which holds
        # _cv) removes the gauge child, so an unlocked check-then-set
        # here could resurrect it right after removal and defeat the
        # cardinality bound.  Never called with _cv held (_expire and
        # _dispatch_group both run outside the lock).
        with self._cv:
            if self._tenants.get(t.name) is t:
                _metrics.SERVE_GOODPUT.set(t.served / t.admitted,
                                           tenant=t.name)

    def _run_dispatch(self, stacked):
        """One predictor dispatch with the registry's OOM second chance: a
        ``DeviceMemoryError`` asks ``oom_retry``, and when it freed memory
        the dispatch runs once more; a second one propagates."""
        try:
            return self._pred._predict_routed(stacked)
        except _memory.DeviceMemoryError as e:
            handler = self._oom_retry
            if handler is None or not handler(e):
                raise
            log.warning("dispatch OOM handled by the budget arbiter — "
                        "retrying once: %s", str(e))
            return self._pred._predict_routed(stacked)

    def _dispatch_group(self, group: List[_Request]) -> None:
        t0 = time.perf_counter()
        # the authoritative expired-work gate, evaluated at dispatch
        # start: _pop_into already filtered, but the hold-open window ran
        # after that — a request that expired in the window is expired
        # here (typed), never padded or dispatched
        dead = [r for r in group
                if r.deadline is not None and t0 >= r.deadline]
        if dead:
            self._expire(dead)
            group = [r for r in group if r not in dead]
            if not group:
                return
        ok = True
        fl = _flight.ENABLED
        if fl:
            record_group_queue_wait(group, _flight.now_us())
        try:
            with group_trace_scope(group):
                with _flight.phase_span("serve_stack", cat="serving"):
                    stacked = stack_requests(self._pred.spec, group)
                # independent tripwire reading for the invariant (pinned
                # at 0 by the tests): dispatch truly starts here
                t_start = time.perf_counter()
                for r in group:
                    if r.deadline is not None and t_start >= r.deadline:
                        self._expired_dispatches += 1
                outs = self._run_dispatch(stacked)
            lo = 0
            for r in group:
                if not r.future.done():
                    r.future.set_result([o[lo:lo + r.rows] for o in outs])
                lo += r.rows
            now = time.perf_counter()
            for r in group:
                t = r.tref
                t.served += 1
                self._publish_goodput(t)
                if _metrics.ENABLED:
                    _metrics.SERVE_LATENCY_SECONDS.observe(
                        now - r.t0, exemplar=r.trace_id)
                if _goodput.ENABLED:
                    _goodput.serve_latency_sample((now - r.t0) * 1e3)
                if fl:
                    _flight.note("serve_request", now - r.t0)
            if _metrics.ENABLED:
                _metrics.SERVE_REQUESTS.inc(len(group))
                _metrics.SERVE_COALESCED_ROWS.set(
                    sum(r.rows for r in group))
        except Exception as e:  # noqa: BLE001 — failures go to callers
            ok = False
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            dt = time.perf_counter() - t0
            self._ewma_s = dt if self._ewma_s == 0.0 else \
                self._ewma_alpha * dt + (1 - self._ewma_alpha) * self._ewma_s
            self._last_dispatch_done = time.perf_counter()
            self._recent.append(ok)

    def _loop(self) -> None:
        try:
            while True:
                res = self._take_group()
                if res is None:
                    return
                group, expired = res
                self._expire(expired)
                if group:
                    # _dispatch_group re-checks deadlines at dispatch
                    # start (requests can expire during the hold-open
                    # window); tracked so _die can fail these futures
                    # too if the dispatch dies with a non-Exception
                    # (worker death) — cleared only on normal return, a
                    # finally would wipe it before _die could read it
                    self._inflight = group
                    self._dispatch_group(group)
                    self._inflight = None
        except BaseException as e:  # noqa: BLE001 — worker death
            # cleanup then exit quietly: _die records the cause (submit
            # raises it), fails every queued future typed, and logs
            self._die(e)

    def _die(self, exc: BaseException) -> None:
        err = BatcherDeadError(
            f"ResilientServer worker died: {type(exc).__name__}: {exc}")
        log.error("%s", err)
        leftovers = list(self._inflight or [])
        self._inflight = None
        with self._cv:
            self._fatal = exc
            for t in self._tenants.values():
                while t.heap:
                    leftovers.append(heapq.heappop(t.heap)[-1])
                t.rows_queued = 0
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(err)

    # -- health / readiness --------------------------------------------------
    def healthz(self) -> dict:
        """Liveness: is the process worth keeping?  (Restart on False —
        the readiness question 'should I get traffic?' is readyz().)"""
        alive = self._thread.is_alive() and self._fatal is None
        return {
            "ok": bool(alive and not self._closed),
            "scheduler_alive": self._thread.is_alive(),
            "watchdog_alive": self._watchdog.is_alive(),
            "closed": self._closed,
            "fatal": None if self._fatal is None else repr(self._fatal),
            "uptime_s": time.perf_counter() - self._t_start,
        }

    def _compute_ready(self) -> Tuple[bool, Dict[str, bool], dict]:
        checks: Dict[str, bool] = {}
        detail: dict = {}
        # 1. warmup: every bucket built at least once — a cold replica
        # would pay bucket builds on its first requests.  Counted over
        # ever-built keys, so an evicted bucket (rebuilt on demand) does
        # not take an otherwise healthy replica out of rotation
        want = len(self._pred.spec.all_keys())
        have = self._pred.num_compiled
        ever = len(getattr(self._pred, "_ever_compiled", ()) or ())
        checks["warmup_complete"] = max(have, ever) >= want
        detail["compiled_buckets"] = f"{have}/{want}"
        try:
            ms = self._pred.memory_stats()
            detail["bucket_peak_bytes"] = ms["peak_bytes_max"]
            detail["serve_weights_bytes"] = ms["weights_bytes"]
        except Exception:  # noqa: BLE001 — stats are best-effort
            pass
        # 2. dispatch latency EWMA vs threshold
        lat_ms = self._ewma_s * 1e3
        detail["dispatch_ewma_ms"] = round(lat_ms, 3)
        checks["dispatch_latency"] = (
            not self.unready_latency_ms
            or lat_ms <= float(self.unready_latency_ms))
        # 3. failure rate over the recent-dispatch window
        recent = list(self._recent)
        rate = (len(recent) - sum(recent)) / len(recent) if recent else 0.0
        detail["failure_rate"] = round(rate, 3)
        checks["failure_rate"] = rate <= self.unready_failure_rate
        # 4. dispatch stall: queued work but nothing completing
        now = time.perf_counter()
        last = self._last_dispatch_done
        detail["last_dispatch_age_s"] = None if last is None \
            else round(now - last, 3)
        with self._cv:
            has_work = self._has_work()
        anchor = last if last is not None else self._t_start
        checks["dispatch_stall"] = not (
            has_work and now - anchor > self.stall_timeout_s)
        # 5. hot-reload freshness (only when auto-reload is running)
        if getattr(self._pred, "_reload_thread", None) is not None:
            staleness = self.reload_staleness_s
            if staleness is None:
                staleness = 3.0 * self._pred._reload_interval_s
            age = time.monotonic() - self._pred._last_reload_ok
            detail["reload_age_s"] = round(age, 3)
            checks["hot_reload_fresh"] = age <= staleness
        # 6. the scheduler itself
        checks["scheduler_alive"] = (self._thread.is_alive()
                                     and self._fatal is None)
        # 6b. the perf-regression sentinel: once a baseline is armed, an
        # active step-time or dispatch regression takes the replica out
        # of rotation (guarded: readiness never fails because of it)
        try:
            from ..observability import introspect as _int
            if _int.ENABLED and _int.sentinel_armed():
                active = _int.regression_active()
                checks["perf_regression"] = not active
                if active:
                    detail["perf_sentinel"] = {
                        p: {"kind": s["kind"],
                            "baseline_p50_ms":
                                (s["baseline"] or {}).get(
                                    "step_time_p50_ms"),
                            "current_p50_ms":
                                (s["current"] or {}).get(
                                    "step_time_p50_ms")}
                        for p, s in _int.sentinel_state()["phases"].items()
                        if s["active"]}
        except Exception:  # noqa: BLE001 — the sentinel is best-effort here
            pass
        # 7. declared SLOs (listed only when an operator declared one)
        if _goodput.ENABLED and _goodput.slo_armed():
            checks["slo_burn"] = not _goodput.slo_burning()
            detail["slo"] = _goodput.slo_state()
        if self._extra_ready is not None:
            try:
                ec, ed = self._extra_ready()
                checks.update(ec or {})
                detail.update(ed or {})
            except Exception:  # noqa: BLE001 — the hook is best-effort
                pass
        ready = all(checks.values()) and not self._closed
        return ready, checks, detail

    def _update_ready(self) -> None:
        ready, checks, detail = self._compute_ready()
        with self._ready_lock:
            if ready != self._ready:
                log.warning("serving readiness %s -> %s (%s)",
                            self._ready, ready,
                            [k for k, v in checks.items() if not v]
                            or "ok")
                if _metrics.ENABLED:
                    _metrics.SERVE_READY_TRANSITIONS.inc(
                        direction="up" if ready else "down")
            self._ready = ready
            self._last_checks = checks
            self._ready_reasons = [k for k, v in checks.items() if not v]
            self._last_detail = detail
            if _metrics.ENABLED:
                _metrics.SERVE_READY.set(1.0 if ready else 0.0)

    def readyz(self) -> dict:
        """Traffic-worthiness: the load balancer's question.  Evaluates
        fresh (the watchdog also refreshes every interval so the gauge
        and transition counter move without anyone polling)."""
        self._update_ready()
        return {"ready": self._ready,
                "reasons": list(self._ready_reasons),
                "checks": dict(self._last_checks),
                "detail": dict(self._last_detail)}

    def _watch(self) -> None:
        while not self._watch_stop.wait(self._watch_interval):
            try:
                self._update_ready()
            except Exception as e:  # noqa: BLE001 — watchdog never dies
                log.warning("readiness watchdog evaluation failed: %s", e)

    def _one_resolved(self, _future) -> None:
        # future resolutions happen outside the cv lock everywhere
        # (_expire/_die/close/dispatch), so taking it here cannot
        # self-deadlock
        with self._cv:
            self._live = max(0, self._live - 1)

    def pending(self) -> int:
        """Admitted requests not yet resolved (queued, being grouped,
        or in flight) — a multi-model registry's is-this-model-idle
        question (a
        model with pending work is never a weights-eviction victim:
        evicting it would fail or thrash the very requests it still
        owes)."""
        with self._cv:
            return self._live

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        """Point-in-time serving stats (the per-server complement of
        ``observability.snapshot()["serving"]``)."""
        with self._cv:
            tenants = {
                t.name: {"admitted": t.admitted, "served": t.served,
                         "expired": t.expired, "shed": t.shed,
                         "queued": len(t.heap),
                         "goodput": (t.served / t.admitted)
                         if t.admitted else 1.0}
                for t in self._tenants.values()}
            depth = self._total_requests()
            rows = self._total_rows()
        return {"tenants": tenants, "queue_depth": depth,
                "rows_queued": rows,
                "dispatch_ewma_ms": round(self._ewma_s * 1e3, 3),
                "expired_dispatches": self._expired_dispatches,
                "ready": self._ready, "max_queue": self.max_queue,
                "shed_policy": self.shed_policy}
