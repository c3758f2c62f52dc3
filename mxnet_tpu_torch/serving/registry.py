"""Multi-model serving under a device-memory budget: registry, LRU
eviction, restart-free readmission, typed degradation ladder (parity:
``mxnet_tpu/serving/registry.py``).

``ModelRegistry`` hosts N ``BucketedPredictor``s, each behind its own
``ResilientServer``, and schedules them against a budget of device bytes:
``budget_mb``, else ``MXNET_HBM_BUDGET_MB``, else the card's memory
(``torch.cuda.mem_get_info``); on the CPU with neither set there is no
budget.

  * **admission asks first** — registering a model, readmitting an
    evicted one, or building a cold bucket checks the memory ledger's
    tracked bytes plus each model's largest measured bucket peak against
    the budget before allocating;
  * **LRU eviction, cheapest first** — on a shortfall the registry
    reclaims decode KV pages (``decode.reclaim_kv_pages``), then cold
    bucket entries (oldest first, across models), then whole cold models'
    device weights (the host payload is kept, so readmission is an upload,
    never a restart).  Pinned models, the requesting model and models with
    pending requests are never weight victims; the arbiter is installed
    process-wide through ``memory.set_budget_arbiter``;
  * **typed degradation ladder** — ``full`` → ``buckets_evicted`` →
    ``weights_evicted`` → ``ModelUnavailable`` (with ``retry_after_s``);
  * **OOM second chance** — a CUDA out-of-memory error (or the
    ``memory.oom`` fault site) at a dispatch makes the registry evict one
    idle model and lets ``ResilientServer`` run the dispatch once more;
  * **tenant routing** — ``bind(tenant, model)`` routes
    ``submit(tenant=...)`` through that model's bounded queues;
  * eviction and readmission run inside ``serve_evict``/``serve_readmit``
    flight phases sampling the ledger, the ``serving.evict`` fault site
    fires once per victim, and ``mxnet_serve_evictions_total{kind,model}``,
    ``mxnet_serve_resident_models`` and ``mxnet_serve_model_hbm_bytes``
    land in ``snapshot()["serving"]``.

Models run on ``dev`` (default the current context, ``gpu(0)``; a gpu
context without a CUDA device raises ``MXNetError``).
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as _np
import torch

from ..analysis import sanitizer as _san
from ..base import MXNetError, getenv
from ..context import as_device, current_context
from ..faultinject import fire as _fi_fire
from ..observability import flight as _flight
from ..observability import journal as _journal
from ..observability import memory as _memory
from ..observability import metrics as _metrics
from .predictor import BucketedPredictor
from .resilience import ResilientServer

log = logging.getLogger(__name__)

__all__ = ["ModelRegistry", "ModelUnavailable", "EVICT_POLICIES",
           "DEGRADATION_LADDER"]

EVICT_POLICIES = ("lru", "none")

#: the typed degradation ladder, least to most degraded — each model is
#: always at exactly one rung; requests only fail typed at the last
DEGRADATION_LADDER = ("full", "buckets_evicted", "weights_evicted",
                      "unavailable")


class ModelUnavailable(MXNetError):
    """The budget cannot host this model right now — every colder
    victim is already evicted (or busy, or eviction is disabled) and
    the bytes still don't fit.  ``retry_after_s`` estimates when churn
    frees capacity; an RPC front end maps it to ``Retry-After``.  This
    is the ladder's last rung: the request never reached the device, so
    there is nothing to OOM."""

    def __init__(self, message: str, retry_after_s: float = 0.5,
                 model: Optional[str] = None):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.model = model


class _Entry:
    __slots__ = ("name", "predictor", "server", "last_used", "pinned")

    def __init__(self, name: str, predictor: BucketedPredictor,
                 server: ResilientServer, pinned: bool):
        self.name = name
        self.predictor = predictor
        self.server = server
        self.last_used = time.monotonic()
        self.pinned = pinned


class ModelRegistry:
    """N serving models in one process under one device-memory budget.

    Parameters
    ----------
    budget_mb : float, optional
        Device-byte budget the registry schedules against (default:
        ``MXNET_HBM_BUDGET_MB``, else the card's memory; on the CPU 0 = no
        budget, everything admits).
        The ledger's soft-budget watchdog stays the hard backstop.
    max_models : int, optional
        Bound on registered models (default ``MXNET_SERVE_MAX_MODELS``,
        16).  Each model costs a scheduler thread pair, per-model metric
        series, and — resident — its weights; past the bound
        ``register`` raises.
    evict_policy : str, optional
        ``"lru"`` (default, ``MXNET_SERVE_EVICT_POLICY``) evicts cold
        buckets then cold models on budget pressure; ``"none"``
        disables eviction — over-budget admissions fail typed
        immediately (capacity planning mode).
    server_kwargs : dict, optional
        Forwarded to every model's ``ResilientServer`` (queue bounds,
        shed policy, watchdog thresholds).
    dev : Context, optional
        Where the models live (default: the current context, ``gpu(0)``).
    """

    def __init__(self, budget_mb: Optional[float] = None,
                 max_models: Optional[int] = None,
                 evict_policy: Optional[str] = None,
                 server_kwargs: Optional[dict] = None, dev=None):
        self._ctx = dev if dev is not None else current_context()
        self._device = as_device(self._ctx)  # raises: gpu without CUDA
        if budget_mb is None:
            budget_mb = float(getenv("MXNET_HBM_BUDGET_MB", 0.0))
        if budget_mb <= 0 and self._device.type == "cuda":
            budget_mb = torch.cuda.mem_get_info(self._device)[1] / 1048576.0
        self.budget_bytes = float(budget_mb) * 1048576.0
        self.max_models = int(getenv("MXNET_SERVE_MAX_MODELS", 16)) \
            if max_models is None else int(max_models)
        if self.max_models < 1:
            raise MXNetError("max_models must be >= 1")
        policy = evict_policy or getenv("MXNET_SERVE_EVICT_POLICY", "lru")
        if policy not in EVICT_POLICIES:
            raise MXNetError(f"evict_policy must be one of "
                             f"{EVICT_POLICIES}, got {policy!r}")
        self.evict_policy = policy
        self._server_kwargs = dict(server_kwargs or {})
        # RLock: admission calls ensure_headroom which re-enters the
        # registry through the arbiter (_make_room) on the same thread
        self._lock = _san.make_rlock("serving.registry")
        self._models: Dict[str, _Entry] = {}
        self._routes: Dict[str, str] = {}   # tenant -> model name
        # bytes promised to in-flight admissions (bucket compiles that
        # have not landed in the ledger yet), keyed (model, bucket)
        # with a holder refcount — released when the last admitting
        # request's future resolves
        self._reserved = 0.0
        self._rsv: Dict[tuple, list] = {}
        self._closed = False
        # the process-wide arbitration hook: OTHER subsystems asking
        # memory.ensure_headroom() get this registry's LRU evictor.
        # ONE bound-method object, pinned — every `self._arbit` access
        # creates a fresh bound method, so close()'s is-ours identity
        # check needs the exact installed object
        self._arbiter_fn = self._arbit
        self._prev_arbiter = _memory.set_budget_arbiter(self._arbiter_fn)

    # -- registration / routing ----------------------------------------------
    def register(self, name: str, symbol, params, input_shapes,
                 tenants=(), warmup: bool = True, pinned: bool = False,
                 server_kwargs: Optional[dict] = None,
                 **predictor_kwargs) -> ResilientServer:
        """Build + admit one model.  ``tenants`` pre-binds routing
        names; ``warmup=True`` builds (and runs once) each
        bucket while the budget allows, leaving the rest cold;
        ``pinned=True`` exempts the model from eviction.  Past the
        budget even after eviction, the model is admitted
        **weights-evicted** (host payload only — it readmits on its
        first request if capacity has freed by then).  Raises on a
        duplicate name or a full registry."""
        with self._lock:
            if self._closed:
                raise MXNetError("ModelRegistry is closed")
            if name in self._models:
                raise MXNetError(f"model {name!r} already registered")
            if len(self._models) >= self.max_models:
                raise MXNetError(
                    f"registry full ({self.max_models} models, "
                    f"MXNET_SERVE_MAX_MODELS) — deregister one first")
        # build outside the lock: param loading can be slow, and the
        # arbiter must stay callable for other admissions.  The
        # predictor constructs resident=False — its host payload is
        # the ONLY copy (no duplicate normalization pass here) and NO
        # device bytes allocate until the budget has answered, so an
        # over-budget registration cannot transiently blow the very
        # budget (or device) it is being checked against
        predictor_kwargs.setdefault("dev", self._ctx)
        pred = BucketedPredictor(symbol, params, input_shapes,
                                 resident=False, **predictor_kwargs)
        est = pred.host_payload_bytes()
        # check AND upload under the registry lock: two concurrent
        # admissions must not both be granted the same headroom.  The
        # upload is a copy per tensor — bounded, unlike a bucket build
        with self._lock:
            fits = self._ensure_fits(est, exclude=name,
                                     why=f"register:{name}")
            if fits:
                pred.readmit()  # first admission: not counted as churn
        kw = dict(self._server_kwargs)
        kw.update(server_kwargs or {})
        server = ResilientServer(
            pred,
            extra_ready=lambda n=name, p=pred: ({}, {
                "model": n, "degradation": self._degradation(p)}),
            oom_retry=lambda e, n=name: self._on_oom(n, e),
            **kw)
        entry = _Entry(name, pred, server, pinned)
        with self._lock:
            # re-check: the build above ran unlocked, so a concurrent
            # register of the same name (or a close()) may have won —
            # a silent overwrite would orphan the loser's scheduler
            # threads and device weights forever
            lost = self._closed or name in self._models \
                or len(self._models) >= self.max_models
            if not lost:
                self._models[name] = entry
                for t in tenants:
                    self._routes[str(t)] = name
        if lost:
            server.close()
            pred.close()
            raise MXNetError(
                f"model {name!r} lost a registration race (duplicate "
                f"name, closed registry, or registry full)")
        if not fits:
            # over budget even after eviction: admitted at the
            # weights_evicted rung (it readmits on its first request
            # once capacity frees)
            log.warning("model %r does not fit the memory budget at "
                        "registration — admitted weights-evicted", name)
        elif warmup:
            self.warmup(name)
        self._refresh_gauges()
        return server

    def warmup(self, name: str, keys=None) -> int:
        """Budget-gated warmup: compile + pre-execute buckets for
        ``name`` until the budget says stop (remaining buckets stay
        cold and compile lazily, budget permitting, at first dispatch).
        Returns the number of buckets made resident."""
        e = self._entry(name)
        done = 0
        for key in (keys if keys is not None
                    else e.predictor.spec.all_keys()):
            key = tuple(key)
            if key in e.predictor._compiled:
                done += 1
                continue
            # grant + reserve under the lock, compile OUTSIDE it: the
            # reservation keeps concurrent admissions honest about the
            # promised bytes without stalling them behind this build
            rk = (e.name, key)
            with self._lock:
                est = self._bucket_increment(e, key)
                if not self._ensure_fits(est, exclude=name,
                                         why=f"warmup:{name}"):
                    log.warning("warmup of %r stopped by the memory "
                                "budget after %d bucket(s) — the rest "
                                "stay cold", name, done)
                    return done
                ent = self._rsv.get(rk)
                if ent is None:
                    ent = self._rsv[rk] = [float(est), 0]
                    self._reserved += ent[0]
                ent[1] += 1
            try:
                e.server.warmup(keys=[key])
            finally:
                self._release_key(rk)
            done += 1
        return done

    def bind(self, tenant: str, model: str) -> None:
        """Route ``tenant``'s requests to ``model`` (``"*"`` = default
        route for unbound tenants)."""
        with self._lock:
            self._entry(model)
            self._routes[str(tenant)] = str(model)

    def deregister(self, name: str) -> None:
        """Remove + tear down one model (server closed, predictor
        closed, routes dropped, ledger bytes returned)."""
        with self._lock:
            e = self._models.pop(name, None)
            if e is None:
                return
            for t in [t for t, m in self._routes.items() if m == name]:
                del self._routes[t]
        e.server.close()
        e.predictor.close()
        if _metrics.ENABLED:
            _metrics.SERVE_MODEL_HBM_BYTES.remove(model=name)
        self._refresh_gauges()

    def models(self) -> List[str]:
        with self._lock:
            return list(self._models)

    def _entry(self, name: str) -> _Entry:
        with self._lock:
            e = self._models.get(name)
        if e is None:
            raise MXNetError(f"unknown model {name!r}; registered: "
                             f"{sorted(self._models)}")
        return e

    def _resolve(self, model: Optional[str], tenant: str) -> _Entry:
        if model is None:
            with self._lock:
                model = self._routes.get(tenant) or self._routes.get("*")
            if model is None:
                raise MXNetError(
                    f"no model routed for tenant {tenant!r} (bind() a "
                    f"route or pass model=)")
        return self._entry(model)

    # -- request path --------------------------------------------------------
    def submit(self, model: Optional[str] = None, tenant: str = "default",
               deadline_ms: Optional[float] = None, priority: int = 0,
               **inputs):
        """Route one request to its model's ``ResilientServer`` queue.

        The budget negotiation happens HERE, on the caller's thread,
        before the request is admitted: a weights-evicted model is
        readmitted (LRU-evicting colder victims to make room) and a
        cold target bucket's compiled peak is reserved.  When the bytes
        cannot be freed — every victim hotter or busy — the request
        fails with a typed ``ModelUnavailable`` carrying
        ``retry_after_s``, and is never admitted (goodput counts only
        admitted work).  Everything after admission is the server's
        contract: bounded queues, deadline shedding, typed errors."""
        e = self._resolve(model, tenant)
        e.last_used = time.monotonic()
        key = None
        try:
            # route outside the lock (pure shape math; reading .shape
            # never syncs a device-resident NDArray the way np.asarray
            # would).  A malformed request leaves key=None and fails
            # typed in server.submit's returned future
            shapes = {}
            for n, v in inputs.items():
                s = getattr(v, "shape", None)
                shapes[n] = tuple(s) if s is not None \
                    else _np.asarray(v).shape
            key = e.predictor.spec.route(shapes)
            if key[0] is None:
                key = None  # oversize: chunks over existing buckets
        except Exception:  # noqa: BLE001 — malformed requests
            key = None
        rsv_key = None
        with self._lock:
            # the budget question is answered UNDER the lock, against
            # residency as it is NOW — a concurrent submit's eviction
            # sweep may have changed it since routing above, and a
            # readmit decided on stale residency would upload weights
            # no headroom was ever granted for
            need = 0 if e.predictor.resident \
                else e.predictor.host_payload_bytes()
            cold_bucket = key is not None \
                and key not in e.predictor._compiled
            # reservations are per (model, bucket), refcounted per
            # request: a burst of N submits to one cold bucket must
            # charge the budget ONE compile, not N (followers ride the
            # first reservation, which _reserved already counts)
            bucket_est = 0
            if cold_bucket and (e.name, key) not in self._rsv:
                bucket_est = self._bucket_increment(e, key)
            if need + bucket_est > 0:
                if not self._ensure_fits(need + bucket_est,
                                         exclude=e.name,
                                         why=f"admit:{e.name}"):
                    retry = self._retry_after()
                    raise ModelUnavailable(
                        f"model {e.name!r} needs ~{need + bucket_est} "
                        f"device bytes the memory budget cannot free "
                        f"(every victim is hotter or busy); retry "
                        f"after ~{retry:.2f}s", retry_after_s=retry,
                        model=e.name)
            if not e.predictor.resident:
                try:
                    self._readmit(e)
                except _memory.DeviceMemoryError as ex:
                    # budget said yes but the device itself is full
                    # (budget off, or untracked pressure): stay on the
                    # ladder — the caller gets retry-after, the
                    # post-mortem dump has already been triggered
                    retry = self._retry_after()
                    raise ModelUnavailable(
                        f"model {e.name!r} readmission hit device "
                        f"memory exhaustion; retry after "
                        f"~{retry:.2f}s", retry_after_s=retry,
                        model=e.name) from ex
            if cold_bucket:
                rsv_key = (e.name, key)
                ent = self._rsv.get(rsv_key)
                if ent is None:
                    ent = self._rsv[rsv_key] = [float(bucket_est), 0]
                    self._reserved += ent[0]
                ent[1] += 1
        fut = None
        try:
            fut = e.server.submit(tenant=tenant, deadline_ms=deadline_ms,
                                  priority=priority, **inputs)
        finally:
            # a shed (Overloaded/closed/dead raise) never attaches the
            # done-callback — release the reservation here or headroom
            # leaks away one shed at a time
            if fut is None and rsv_key is not None:
                self._release_key(rsv_key)
        if rsv_key is not None:
            fut.add_done_callback(
                lambda _f, k=rsv_key: self._release_key(k))
        return fut

    def predict(self, model: Optional[str] = None, tenant: str = "default",
                deadline_ms: Optional[float] = None, priority: int = 0,
                **inputs):
        """Blocking ``submit`` — raises the typed ladder errors
        (``ModelUnavailable`` / ``Overloaded`` / ``DeadlineExceeded``)
        in the caller's thread."""
        return self.submit(model=model, tenant=tenant,
                           deadline_ms=deadline_ms, priority=priority,
                           **inputs).result()

    def _release_key(self, rk: tuple) -> None:
        """Drop one request's hold on a (model, bucket) reservation;
        the reserved bytes return to headroom when the LAST holder's
        future resolves (by then the compile — if it happened — is in
        _mem_stats and counted by _committed_bytes instead)."""
        with self._lock:
            ent = self._rsv.get(rk)
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] <= 0:
                self._reserved = max(0.0, self._reserved - ent[0])
                del self._rsv[rk]

    # -- the budget scheduler ------------------------------------------------
    # Cost model: a model's budget footprint is its tracked ledger bytes
    # (weights + placeholders — the weakref ledger is ground truth) PLUS
    # its largest resident bucket's measured peak (the allocator's peak
    # over the bucket's warm-up forward: the transient working set one
    # dispatch needs; one dispatch at a time per model).  On the CPU no
    # peak is measured: weights still budget, bucket churn frees only
    # its tracked placeholders.
    def _committed_bytes(self) -> float:
        """Sum over models of the largest RESIDENT bucket's compiled
        peak — dispatch working set the budget must hold in reserve."""
        total = 0.0
        with self._lock:
            entries = list(self._models.values())
        for e in entries:
            try:
                total += e.predictor.memory_stats()["peak_bytes_max"]
            except Exception:  # noqa: BLE001 — stats are best-effort
                pass
        return total

    def _headroom(self) -> float:
        h = _memory.headroom_bytes(
            self.budget_bytes if self.budget_bytes > 0 else None)
        if h == float("inf"):
            return h
        return h - self._reserved - self._committed_bytes()

    def _ensure_fits(self, nbytes: float, exclude: Optional[str],
                     why: str) -> bool:
        """True when ``nbytes`` more device bytes fit the budget,
        LRU-evicting cold buckets then cold models to make it so."""
        if self.budget_bytes <= 0 or nbytes <= 0:
            return True
        h = self._headroom()
        if h >= nbytes:
            return True
        self._make_room(nbytes - h, exclude=exclude, why=why)
        return self._headroom() >= nbytes

    def _bucket_increment(self, e: "_Entry", key: tuple) -> int:
        """Budget increment of making bucket ``key`` resident: its
        compiled-peak estimate beyond the model's current largest
        resident bucket (the committed term counts only the max)."""
        est = e.predictor.bucket_cost_estimate(key)
        try:
            cur = e.predictor.memory_stats()["peak_bytes_max"]
        except Exception:  # noqa: BLE001
            cur = 0
        return max(0, int(est) - int(cur))

    def _arbit(self, deficit: float, why: str) -> float:
        """The ``memory.set_budget_arbiter`` hook: any subsystem asking
        ``memory.ensure_headroom`` for device bytes gets this
        registry's LRU evictor."""
        return self._make_room(deficit, exclude=None, why=why)

    def _make_room(self, deficit: float, exclude: Optional[str],
                   why: str) -> float:
        """Free ~``deficit`` budget bytes: phase 1 evicts cold bucket
        entries (oldest last-use first, across models), phase 2
        evicts whole cold models' weights (LRU, idle only).  Progress
        is MEASURED — tracked ledger delta + committed bucket-peak
        delta — not trusted from estimates, so a backend with no
        measured peaks still converges (bucket churn frees little
        there; model eviction does the work).  The requesting model
        (``exclude``), pinned models, and models with pending requests
        are never weight-eviction victims.  Returns bytes freed."""
        if self.evict_policy != "lru":
            return 0.0
        with self._lock:
            t0 = _memory.tracked_bytes()
            c0 = self._committed_bytes()

            def _freed():
                return ((t0 - _memory.tracked_bytes())
                        + (c0 - self._committed_bytes()))

            # phase 0: decode KV pages — the CHEAPEST victims in the
            # ladder (an evicted sequence retries with a typed
            # retry-after; an evicted bucket recompiles, an evicted
            # model re-uploads weights).  Lazy import: decode never
            # imports the registry, so no cycle — and a process with
            # no engine alive pays one cached-import check
            if _freed() < deficit:
                try:
                    from . import decode as _decode
                    _decode.reclaim_kv_pages(deficit - _freed(),
                                             why=why)
                except Exception as e:  # noqa: BLE001 — best-effort
                    log.debug("decode KV reclaim skipped: %s", str(e))

            # phase 1: cold buckets — cheapest churn (a readmission is
            # a rebuild, the weights never move)
            cands = []
            for e in self._models.values():
                if e.name == exclude or e.pinned:
                    continue
                for key, used in e.predictor.resident_bucket_ages():
                    cands.append((used, e, key))
            for _used, e, key in sorted(cands, key=lambda c: c[0]):
                if _freed() >= deficit:
                    break
                self._evict_bucket(e, key, why=why, blocking=False)
            if _freed() < deficit:
                # phase 2: cold models, least recently used first
                victims = sorted(
                    (e for e in self._models.values()
                     if e.name != exclude and not e.pinned
                     and e.predictor.resident),
                    key=lambda e: e.last_used)
                for e in victims:
                    if _freed() >= deficit:
                        break
                    if e.server.pending():
                        continue  # owes queued/in-flight requests
                    self._evict_model(e, why=why)
            return max(0.0, _freed())

    def _evict_bucket(self, e: _Entry, key: tuple, why: str,
                      blocking: bool = True) -> float:
        try:
            # chaos site: fired BEFORE any state is dropped, so a raise
            # rule models a failed eviction — the victim stays fully
            # resident and the budgeter moves to the next candidate.
            # blocking=False skips victims whose compile lock is busy
            # (an in-flight compile means the bucket is not cold, and
            # waiting would stall every admission behind one bucket
            # compile while the registry lock is held)
            _fi_fire("serving.evict", model=e.name, kind="bucket",
                     why=why)
            with _flight.phase_span("serve_evict", cat="serving",
                                    mem=True, labels={"model": e.name}):
                freed = e.predictor.evict_bucket(key, blocking=blocking)
        except Exception as ex:  # noqa: BLE001 — skip this victim
            # str(ex): a buffered LogRecord holding the exception
            # object would pin its traceback frames (and any device
            # buffers they reference)
            log.warning("bucket eviction of %r failed (%s); skipping: "
                        "%s", e.name, why, str(ex))
            return 0.0
        if freed and _metrics.ENABLED:
            _metrics.SERVE_EVICTIONS.inc(kind="bucket", model=e.name)
        if freed and _journal.ENABLED:
            _journal.emit("serve_degradation", model=e.name,
                          kind="bucket", why=why,
                          level=self._degradation(e.predictor))
        return float(freed)

    def _evict_model(self, e: _Entry, why: str) -> float:
        try:
            _fi_fire("serving.evict", model=e.name, kind="model",
                     why=why)
            with _flight.phase_span("serve_evict", cat="serving",
                                    mem=True, labels={"model": e.name}):
                # non-blocking for the same reason as bucket sweeps: a
                # victim mid-compile (registry warmup on another
                # thread) is not cold, and waiting here would stall
                # every admission behind its build while the
                # registry lock is held
                freed = e.predictor.evict(blocking=False)
        except Exception as ex:  # noqa: BLE001 — skip this victim
            log.warning("model eviction of %r failed (%s); skipping: %s",
                        e.name, why, str(ex))
            return 0.0
        if freed == 0 and e.predictor.resident:
            return 0.0  # compile-lock busy: victim skipped, not evicted
        if _metrics.ENABLED:
            _metrics.SERVE_EVICTIONS.inc(kind="model", model=e.name)
        if _journal.ENABLED:
            _journal.emit("serve_degradation", model=e.name,
                          kind="model", why=why,
                          level=self._degradation(e.predictor))
        self._refresh_gauges()
        return float(freed)

    def _readmit(self, e: _Entry) -> None:
        with _flight.phase_span("serve_readmit", cat="serving",
                                mem=True, labels={"model": e.name}):
            e.predictor.readmit()
        if _journal.ENABLED:
            _journal.emit("serve_degradation", model=e.name,
                          kind="readmit",
                          level=self._degradation(e.predictor))
        self._refresh_gauges()

    def _on_oom(self, name: str, exc) -> bool:
        """``ResilientServer``'s OOM second chance: the device is
        GENUINELY over — cold-bucket churn is too small to matter, so
        evict one whole LRU idle model (beyond the OOMing one) if any
        exists, then grant ONE dispatch retry either way (cheap,
        bounded: a second OOM propagates typed — and transient
        pressure, e.g. another model's in-flight dispatch peak, may
        have passed even when nothing was evictable).  False only when
        eviction policy is off."""
        if self.evict_policy != "lru":
            return False
        with self._lock:
            victims = sorted(
                (e for e in self._models.values()
                 if e.name != name and not e.pinned
                 and e.predictor.resident and not e.server.pending()),
                key=lambda e: e.last_used)
            for e in victims:
                if self._evict_model(e, why=f"oom:{name}") > 0:
                    break
        return True

    def _retry_after(self) -> float:
        """When might churn free capacity?  The soonest-draining busy
        victim's estimated wait, floored at 50ms."""
        with self._lock:
            ests = [e.server._estimate_wait_s(
                e.server._total_rows() or 1)
                for e in self._models.values() if e.server.pending()]
        return max(0.05, min(ests)) if ests else 0.5

    # -- introspection -------------------------------------------------------
    def degradation(self, name: str) -> str:
        """The model's current rung on ``DEGRADATION_LADDER``."""
        return self._degradation(self._entry(name).predictor)

    @staticmethod
    def _degradation(pred: BucketedPredictor) -> str:
        """Rung from a held predictor — readyz()/stats()/extra_ready
        use this so a concurrent deregister cannot turn the health
        endpoint into an unknown-model raise mid-churn."""
        if not pred.resident:
            return "weights_evicted"
        # list() snapshots: a dispatch thread's first-time compile
        # mutates _ever_compiled/_compiled while a scrape thread reads
        # here
        compiled = dict(pred._compiled)
        if any(k not in compiled for k in list(pred._ever_compiled)):
            return "buckets_evicted"
        return "full"

    def _refresh_gauges(self) -> None:
        if not _metrics.ENABLED:
            return
        with self._lock:
            entries = list(self._models.values())
        resident = 0
        items = []
        for e in entries:
            try:
                ms = e.predictor.memory_stats()
            except Exception:  # noqa: BLE001 — gauges are best-effort
                continue
            if e.predictor.resident:
                resident += 1
                items.append(({"model": e.name}, ms["weights_bytes"]))
            else:
                items.append(({"model": e.name}, 0))
        _metrics.SERVE_RESIDENT_MODELS.set(float(resident))
        _metrics.SERVE_MODEL_HBM_BYTES.replace_children(items)

    def readyz(self) -> dict:
        """Aggregated traffic-worthiness: the registry is ready when
        every model's scheduler is healthy and at least one model can
        take traffic; per-model blocks carry each server's full
        ``readyz`` plus the degradation rung (an evicted model is NOT
        unready — it readmits on demand; only a dead scheduler is)."""
        self._refresh_gauges()
        models = {}
        with self._lock:
            entries = list(self._models.items())
        healthy, any_ready = True, False
        for name, e in entries:
            rz = e.server.readyz()
            hz = e.server.healthz()
            models[name] = {
                "ready": rz["ready"],
                "degradation": self._degradation(e.predictor),
                "reasons": rz["reasons"],
                "detail": rz["detail"],
                "healthy": hz["ok"],
            }
            healthy = healthy and hz["ok"]
            any_ready = any_ready or rz["ready"]
        with self._lock:
            reserved = self._reserved
        return {
            "ready": bool(healthy and (any_ready or not entries)),
            "models": models,
            "budget": {
                "budget_bytes": self.budget_bytes,
                "tracked_bytes": int(_memory.tracked_bytes()),
                "reserved_bytes": int(reserved),
                "headroom_bytes": (None if self.budget_bytes <= 0
                                   else int(self._headroom())),
                "evict_policy": self.evict_policy,
            },
        }

    def stats(self) -> dict:
        with self._lock:
            entries = list(self._models.items())
            routes = dict(self._routes)
        return {
            "models": {n: {"degradation": self._degradation(e.predictor),
                           "resident": e.predictor.resident,
                           "resident_buckets": e.predictor.num_compiled,
                           "last_used": e.last_used,
                           "pinned": e.pinned,
                           "server": e.server.stats()}
                       for n, e in entries},
            "routes": routes,
            "budget_bytes": self.budget_bytes,
            "reserved_bytes": self._reserved,
            "evict_policy": self.evict_policy,
        }

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Tear every model down and uninstall the budget arbiter.
        After close + the caller dropping its references, every
        serve_weights / serve_host_params ledger byte is back to
        baseline (the registry leak gate pins this)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            names = list(self._models)
        # restore whatever arbiter we displaced (usually None) — but
        # only if ours is still installed: closing an older registry
        # must not rip out (or shadow with a dead evictor) the arbiter
        # a NEWER registry has since installed.  And never reinstall a
        # CLOSED registry's evictor (out-of-order close: A then B
        # would otherwise resurrect closed A's no-op arbiter and pin
        # its object alive)
        prev = self._prev_arbiter
        owner = getattr(prev, "__self__", None)
        if isinstance(owner, ModelRegistry) and owner._closed:
            prev = None
        cur = _memory.set_budget_arbiter(prev)
        if cur is not self._arbiter_fn:
            _memory.set_budget_arbiter(cur)
        for n in names:
            self.deregister(n)
        if _metrics.ENABLED:
            _metrics.SERVE_RESIDENT_MODELS.set(0.0)
            _metrics.SERVE_MODEL_HBM_BYTES.replace_children([])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
