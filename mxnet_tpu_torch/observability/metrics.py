"""Metrics registry: counters, gauges, histograms with labels, the
Prometheus-text / JSON exporters, and the port's metrics (parity:
``mxnet_tpu/observability/metrics.py``).

The same primitives and names as the JAX package: the serving metrics
(``SERVE_*``), and those the observability and resilience hooks write —
fault injection, checkpoints, the sanitizer, flight dumps, the memory
ledger, the training supervisor, the prefetcher, data waits, goodput and
SLO burn; the dispatch gauges, the multi-model registry's and the
continuous-batching decode's metrics, and the program introspector's
gauges (MFU, roofline), computed at export.

A **dispatch** in the port is one host entry into a compiled unit — a
CUDA-graph replay (or, off the card, the eager step it stands for), a
``GraphPlan.run``, a ``FusedUpdater.update_all`` — plus each
host-to-device copy a step issues.  Units run inside another unit (the
graph run and the update inside a whole step) do not count again, so a
whole step reads 1, a captured superstep 1 per K steps and a demoted one
about K, as the JAX package's XLA launches + device_puts do.

Design rules:

  - module-level fast-path flag: every runtime hook reads ``ENABLED``
    (plain module global) before touching a metric, so
    ``MXNET_METRICS_ENABLED=0`` costs one boolean test per hook;
  - stable identity: metrics are created ONCE at import and looked up by
    attribute, never by name on the hot path;
  - on-demand expensive data: the CUDA allocator's numbers
    (``torch.cuda.memory_stats``/``mem_get_info``) are read inside
    ``snapshot()``/the exporters, never per step.
"""
from __future__ import annotations

import json as _json
import threading
from typing import Dict, List, Optional, Tuple

from ..base import getenv
from ..analysis.sanitizer import make_lock as _make_lock

ENABLED: bool = getenv("MXNET_METRICS_ENABLED", True)


def enabled() -> bool:
    return ENABLED


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


# One shared mutation lock: hooks fire from the training thread, request
# threads, serving dispatchers and data-pipeline producer threads; an
# unguarded read-modify-write would drop increments.  (A plain
# threading.Lock unless MXNET_SANITIZE=1.)
_MUT_LOCK = _make_lock("metrics.mut")


def _label_key(labels: dict) -> Tuple:
    return tuple(sorted(labels.items()))


class Metric:
    """Base: name + help + label-set → value(s)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", registry=None):
        self.name = name
        self.help = help
        (registry if registry is not None else REGISTRY)._register(self)

    def reset(self) -> None:
        raise NotImplementedError

    def samples(self) -> List[Tuple[str, Tuple, float]]:
        """[(series_name, label_items, value)] for the exporters."""
        raise NotImplementedError


class Counter(Metric):
    """Monotonic counter.  The unlabeled path is one float add (hot-path
    safe); labeled children live in a dict keyed by sorted label items."""

    kind = "counter"

    def __init__(self, name, help="", registry=None):
        self._value = 0.0
        self._children: Dict[Tuple, float] = {}
        super().__init__(name, help, registry)

    def inc(self, value: float = 1.0, **labels) -> None:
        if labels:
            k = _label_key(labels)
            with _MUT_LOCK:
                self._children[k] = self._children.get(k, 0.0) + value
        else:
            with _MUT_LOCK:
                self._value += value

    @property
    def value(self) -> float:
        # list() snapshots in one GIL-atomic C copy: hook threads may
        # insert a new label key while we read
        return self._value + sum(list(self._children.values()))

    def get(self, **labels) -> float:
        return self._children.get(_label_key(labels), 0.0) if labels \
            else self._value

    def reset(self) -> None:
        self._value = 0.0
        self._children.clear()

    def fold_label(self, label: str, value, replacement) -> None:
        """Merge every child whose ``label`` equals ``value`` into the
        same label set with ``label=replacement`` — bounds label
        cardinality (e.g. evicted serving tenants fold into
        ``tenant="_evicted"``) while preserving the counter's total."""
        with _MUT_LOCK:
            for k in [k for k in list(self._children)
                      if dict(k).get(label) == value]:
                v = self._children.pop(k)
                d = dict(k)
                d[label] = replacement
                nk = _label_key(d)
                self._children[nk] = self._children.get(nk, 0.0) + v

    def samples(self):
        out = []
        if self._value or not self._children:
            out.append((self.name, (), self._value))
        for k, v in sorted(list(self._children.items())):
            out.append((self.name, k, v))
        return out


class Gauge(Metric):
    """Point-in-time value; optional callback makes it computed-on-read
    (used for device memory so the allocator is read only at export time)."""

    kind = "gauge"

    def __init__(self, name, help="", registry=None, fn=None):
        self._value = 0.0
        self._children: Dict[Tuple, float] = {}
        self._fn = fn
        super().__init__(name, help, registry)

    def set(self, value: float, **labels) -> None:
        if labels:
            k = _label_key(labels)
            # same lock as replace_children(): a labeled set racing the
            # full-child-set swap must not land in the orphaned old dict
            # and vanish from every future export
            with _MUT_LOCK:
                self._children[k] = float(value)
        else:
            self._value = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        if labels:
            k = _label_key(labels)
            with _MUT_LOCK:
                self._children[k] = self._children.get(k, 0.0) + value
        else:
            with _MUT_LOCK:
                self._value += value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def get(self, **labels) -> float:
        if self._fn is not None and not labels:
            return float(self._fn())
        return self._children.get(_label_key(labels), 0.0) if labels \
            else self._value

    def remove(self, **labels) -> None:
        """Drop one labeled child (gauges are point-in-time, so removal
        is semantically clean — used to keep per-tenant gauge
        cardinality bounded when a tenant is evicted)."""
        with _MUT_LOCK:
            self._children.pop(_label_key(labels), None)

    def replace_children(self, items) -> None:
        """Atomically swap the FULL labeled-child set from an iterable
        of ``(labels_dict, value)`` — one reference assignment, so an
        export racing the rebuild sees either the old or the new
        complete set, never a half-built one (the export-time pull
        refresh idiom, e.g. the memory ledger's per-tag gauge)."""
        children = {_label_key(labels): float(v) for labels, v in items}
        with _MUT_LOCK:
            # same lock discipline as inc/dec/remove — a concurrent
            # labeled mutator must not land its write in the orphaned
            # old dict and vanish from every future export
            self._children = children

    def reset(self) -> None:
        self._value = 0.0
        self._children.clear()

    def samples(self):
        if self._fn is not None:
            try:
                out = [(self.name, (), float(self._fn()))]
            except Exception:
                out = [(self.name, (), 0.0)]
            # computed gauges may ALSO carry labeled children (the
            # per-mesh-axis MFU/flops splits refreshed by the fn pull)
            for k, v in sorted(list(self._children.items())):
                out.append((self.name, k, v))
            return out
        out = []
        if self._value or not self._children:
            out.append((self.name, (), self._value))
        for k, v in sorted(list(self._children.items())):
            out.append((self.name, k, v))
        return out


# default: latency-ish spread from 100us to ~100s
_DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0,
                    5.0, 10.0, 60.0)


class Histogram(Metric):
    """Fixed-bucket histogram (cumulative `le` buckets on export, like
    Prometheus); tracks sum + count so mean is recoverable.

    ``observe(value, exemplar=...)`` additionally remembers the latest
    exemplar (a flight-recorder trace_id) per bucket — the OpenMetrics
    exemplar idea: a p99 bucket links to one concrete recorded request
    timeline instead of an anonymous count (``exemplars()``,
    ``snapshot()["serving"]["latency_exemplars"]``)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=_DEFAULT_BUCKETS,
                 registry=None):
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._count = 0
        self._exemplars: Dict[int, Tuple[float, object]] = {}
        super().__init__(name, help, registry)

    def observe(self, value: float, exemplar=None) -> None:
        with _MUT_LOCK:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    if exemplar is not None:
                        self._exemplars[i] = (value, exemplar)
                    return
            self._counts[-1] += 1
            if exemplar is not None:
                self._exemplars[len(self.buckets)] = (value, exemplar)

    def exemplars(self) -> Dict[str, dict]:
        """{le: {"value", "trace_id"}} for buckets that have one —
        the hop from a latency percentile to `flight` dump spans."""
        with _MUT_LOCK:
            items = list(self._exemplars.items())
        out = {}
        for i, (v, ex) in sorted(items):
            le = "+Inf" if i >= len(self.buckets) \
                else repr(float(self.buckets[i]))
            out[le] = {"value": v, "trace_id": ex}
        return out

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._exemplars.clear()

    def samples(self):
        out, cum = [], 0
        for b, c in zip(self.buckets, self._counts):
            cum += c
            out.append((self.name + "_bucket", (("le", repr(float(b))),), cum))
        cum += self._counts[-1]
        out.append((self.name + "_bucket", (("le", "+Inf"),), cum))
        out.append((self.name + "_sum", (), self._sum))
        out.append((self.name + "_count", (), self._count))
        return out


class MetricsRegistry:
    """Name → Metric; collect/export/reset over the whole set."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = _make_lock("metrics.registry")

    def _register(self, metric: Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        return list(self._metrics.values())

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    # -- exporters ----------------------------------------------------------
    def render_prometheus(self) -> str:
        lines = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for series, labels, value in m.samples():
                sel = ""
                if labels:
                    sel = "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
                v = repr(float(value)) if isinstance(value, float) \
                    else str(value)
                lines.append(f"{series}{sel} {v}")
        return "\n".join(lines) + "\n"

    def render_json(self) -> str:
        return _json.dumps(self.to_dict(), sort_keys=True)

    def to_dict(self) -> dict:
        out = {}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                out[m.name] = {"type": "histogram", "sum": m.sum,
                               "count": m.count, "mean": m.mean,
                               "buckets": {repr(float(b)): c for b, c in
                                           zip(m.buckets, m._counts)},
                               "inf": m._counts[-1]}
            else:
                series = {}
                for name_, labels, value in m.samples():
                    key = ",".join(f"{k}={v}" for k, v in labels) or "_"
                    series[key] = value
                out[m.name] = {"type": m.kind, "values": series}
        return out


REGISTRY = MetricsRegistry()

# -- the serving metrics (names and labels as in the JAX package) -----------
SERVE_REQUESTS = Counter(
    "mxnet_serve_requests_total",
    "Inference requests served by the serving fast path "
    "(mxnet_tpu_torch.serving), coalesced or not")
SERVE_BATCHES = Counter(
    "mxnet_serve_batches_total",
    "Bucket dispatches issued by the serving fast path — one graph run "
    "each; requests/batches is the coalescing factor")
SERVE_COMPILES = Counter(
    "mxnet_serve_compiles_total",
    "Bucket entries built (and warmed with one forward on zeros).  After "
    "warmup() this must stay FLAT under traffic — growth means requests "
    "are escaping the bucket set")
SERVE_QUEUE_DEPTH = Gauge(
    "mxnet_serve_queue_depth",
    "Requests waiting in the micro-batcher queue (sampled at "
    "submit/drain)")
SERVE_PADDING_WASTE = Gauge(
    "mxnet_serve_padding_waste",
    "Fraction of the most recent serving dispatch's input elements that "
    "were bucket padding (dead compute).  Persistently high means the "
    "bucket ladder is too coarse for the traffic: widen "
    "MXNET_SERVE_BUCKETS")
SERVE_COALESCED_ROWS = Gauge(
    "mxnet_serve_coalesced_rows",
    "Rows in the most recent coalesced micro-batch (before bucket "
    "padding)")
SERVE_LATENCY_SECONDS = Histogram(
    "mxnet_serve_request_seconds",
    "End-to-end request latency through the serving fast path (includes "
    "micro-batcher queue wait on the coalesced path)",
    buckets=(1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
             5e-2, 0.1, 0.25, 1.0, 5.0))
SERVE_ADMITTED = Counter(
    "mxnet_serve_admitted_total",
    "Requests admitted past ResilientServer admission control, by "
    "tenant (shed requests never count here)")
SERVE_SHED = Counter(
    "mxnet_serve_shed_total",
    "Requests rejected by admission control with a typed Overloaded "
    "error, by tenant and reason (queue_full = per-tenant bound hit, "
    "deadline_unmeetable = estimated wait already exceeds the request's "
    "deadline)")
SERVE_EXPIRED = Counter(
    "mxnet_serve_expired_total",
    "Admitted requests dropped before dispatch because their deadline "
    "passed in queue (typed DeadlineExceeded to the caller; expired "
    "work is never padded or dispatched), by tenant")
SERVE_GOODPUT = Gauge(
    "mxnet_serve_goodput",
    "served / admitted fraction per tenant since process start")
SERVE_READY = Gauge(
    "mxnet_serve_ready",
    "1 when the most recently evaluated ResilientServer readyz() "
    "passes (warmup complete, dispatch latency / failure rate / stall "
    "within thresholds), else 0")
SERVE_READY_TRANSITIONS = Counter(
    "mxnet_serve_ready_transitions_total",
    "readyz flips, by direction (up = became ready, down = became "
    "unready)")
SERVE_READMITS = Counter(
    "mxnet_serve_readmissions_total",
    "Readmissions of evicted serving state, by kind (model = weights "
    "re-uploaded from the host payload, bucket = an evicted bucket's "
    "entry rebuilt; never counted as a SERVE_COMPILES escape)")
SERVE_BUCKET_HBM_BYTES = Gauge(
    "mxnet_serve_bucket_hbm_bytes",
    "Peak device bytes allocated while a serving bucket's entry ran its "
    "warm-up forward (torch.cuda.max_memory_allocated, set once per "
    "bucket; labels are the bounded bucket-lattice set)")

SERVE_EVICTIONS = Counter(
    "mxnet_serve_evictions_total",
    "LRU evictions by the multi-model budgeter (serving.ModelRegistry), "
    "by kind (kv = a decode sequence's KV pages, bucket = one bucket's "
    "entry and its placeholders, model = the device weights too; the "
    "host payload is kept for readmission) and model")
SERVE_RESIDENT_MODELS = Gauge(
    "mxnet_serve_resident_models",
    "Registered serving models whose device weights are resident "
    "(ModelRegistry)")
SERVE_MODEL_HBM_BYTES = Gauge(
    "mxnet_serve_model_hbm_bytes",
    "Tracked device bytes per registered serving model (weights and "
    "bucket placeholders; 0 while weights-evicted), by model")
SERVE_RELOAD_FAILURES = Counter(
    "mxnet_serve_reload_failures_total",
    "Serving auto-reload poll failures (missing or corrupt checkpoint "
    "directory, a failed weight swap); each kept the old weights")
DECODE_STEPS = Counter(
    "mxnet_decode_steps_total",
    "Continuous-batching decode steps (serving.DecodeEngine): each is ONE "
    "CUDA-graph replay over the whole in-flight slot set on the card")
DECODE_TOKENS = Counter(
    "mxnet_decode_tokens_total",
    "Tokens generated by continuous-batching decode (prompt-consuming "
    "steps excluded)")
DECODE_KV_EVICTIONS = Counter(
    "mxnet_decode_kv_evictions_total",
    "Sequences whose KV pages were reclaimed under memory pressure "
    "(typed SequenceEvicted with retry-after to the caller)")
DECODE_INFLIGHT = Gauge(
    "mxnet_decode_inflight_sequences",
    "Sequences holding a decode slot, refreshed every decode step")
DECODE_KV_OCCUPANCY = Gauge(
    "mxnet_decode_kv_page_occupancy",
    "Fraction of the routed KV lattice key's token capacity holding live "
    "sequence state")
DECODE_TOKENS_PER_S = Gauge(
    "mxnet_decode_tokens_per_second",
    "Active sequences advanced by the most recent decode step / its "
    "wall-clock")

# -- dispatch accounting ----------------------------------------------------
DISPATCHES = Counter(
    "mxnet_dispatches_total",
    "Host entries into a compiled unit (a CUDA-graph replay or the eager "
    "step it stands for, a GraphPlan.run, a FusedUpdater.update_all), by "
    "kind, plus host-to-device copies a step issues (kind h2d); units "
    "nested in another unit are not counted again")
FIT_STEP_DISPATCHES = Gauge(
    "mxnet_fit_step_dispatches",
    "Dispatches (compiled-unit entries + host-to-device copies) of the "
    "most recent Module.fit step")
TRAINER_STEP_DISPATCHES = Gauge(
    "mxnet_trainer_step_dispatches",
    "Dispatches of the most recent gluon training step: the fused path's "
    "Trainer.step (reduce and update; forward and backward run outside "
    "it); the whole step (MXNET_WHOLE_STEP=1) the whole step, one CUDA "
    "graph replay, so it reads 1")
SUPERSTEP_DISPATCHES = Gauge(
    "mxnet_superstep_dispatches",
    "Dispatches of the most recent superstep: 1 for K captured steps, "
    "about K when it demoted to K sequential whole steps (what the perf "
    "sentinel's superstep baseline trips on)")
PERF_REGRESSIONS = Counter(
    "mxnet_perf_regressions_total",
    "Perf-regression sentinel firings (observability.introspect), by kind "
    "(step_time = the warmed step time blew the persisted baseline p50 by "
    "REGRESSION_FACTOR, dispatches = dispatches per step grew past the "
    "baseline) and phase; once per episode, and the perf_regression "
    "readyz() check fails until it clears or the baseline is refreshed")

_unit_tls = threading.local()


def step_dispatches() -> float:
    """Dispatches so far (the gauges publish per-step deltas of this)."""
    return DISPATCHES.value


def dispatch_counts() -> Dict[str, float]:
    out = {dict(k).get("kind", "other"): v
           for k, v in list(DISPATCHES._children.items())}
    out["total"] = DISPATCHES.value
    return out


class dispatch_unit:
    """``with dispatch_unit(kind):`` one entry into a compiled unit:
    counts 1 unless a unit is already open on this thread.  ``kind=None``
    counts nothing and keeps the units inside from counting (the
    introspector's counting runs on the meta device)."""
    __slots__ = ("kind", "_outer")

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        d = getattr(_unit_tls, "depth", 0)
        self._outer = d
        if d == 0 and ENABLED and self.kind is not None:
            DISPATCHES.inc(kind=self.kind)
        _unit_tls.depth = d + 1
        return self

    def __exit__(self, *exc):
        _unit_tls.depth = self._outer
        return False


def note_h2d() -> None:
    """One host-to-device copy issued by a step."""
    if ENABLED:
        DISPATCHES.inc(kind="h2d")


# -- the observability and resilience hooks' metrics ----------------------
DATA_WAIT_SECONDS = Histogram(
    "mxnet_data_batch_wait_seconds",
    "Time the training loop waited for the next data batch")
PREFETCH_WAIT_SECONDS = Histogram(
    "mxnet_prefetch_wait_seconds",
    "Time the consumer blocked on the prefetch-to-device queue; near "
    "zero when the input pipeline keeps ahead of the device")
FAULTS_INJECTED = Counter(
    "mxnet_faults_injected_total",
    "Faults fired by the faultinject harness, by site and "
    "mode.  Nonzero in production means someone left MXNET_FAULT_PLAN "
    "set")
CHECKPOINT_SAVE_SECONDS = Histogram(
    "mxnet_checkpoint_save_seconds",
    "Full wall-clock of each checkpoint save, snapshot through atomic "
    "commit (async saves: measured on the writer thread)")
CHECKPOINT_SAVE_BLOCKED_SECONDS = Histogram(
    "mxnet_checkpoint_save_blocked_seconds",
    "Time CheckpointManager.save() blocked its caller — the step "
    "critical-path cost.  Async mode: just the device->host snapshot; "
    "sync mode: the whole write")
CHECKPOINT_RESTORE_SECONDS = Histogram(
    "mxnet_checkpoint_restore_seconds",
    "Wall-clock of each successful checkpoint restore (CRC validation "
    "included)")
CHECKPOINT_BYTES_WRITTEN = Counter(
    "mxnet_checkpoint_bytes_written_total",
    "Payload bytes committed by checkpoint saves (shard files)")
CHECKPOINT_LAST_STEP = Gauge(
    "mxnet_checkpoint_last_step",
    "Step of the most recent successfully committed checkpoint — a "
    "flat-lining value under traffic is the page-the-oncall signal "
    "that durable state has stopped advancing")
CHECKPOINT_FAILURES = Counter(
    "mxnet_checkpoint_failures_total",
    "Checkpoint subsystem failures by stage (save_attempt = retried "
    "transient IO error, save = retries exhausted, restore = torn/"
    "corrupt checkpoint skipped, gc = retention sweep error) and "
    "reason")
ANALYSIS_LOCK_VIOLATIONS = Counter(
    "mxnet_analysis_lock_order_violations_total",
    "Concurrency-sanitizer lock findings under MXNET_SANITIZE=1, by "
    "kind (cycle = ABBA ordering hazard across subsystem locks, "
    "reentry = same-thread re-acquisition of a non-reentrant lock, "
    "e.g. a SIGTERM handler mid-save).  Nonzero anywhere, "
    "including chaos runs, is a bug")
ANALYSIS_SYNC_VIOLATIONS = Counter(
    "mxnet_analysis_sync_violations_total",
    "Device->host syncs observed inside analysis.no_sync() regions "
    "(the runtime check of the host-sync discipline)")
FLIGHT_DUMPS = Counter(
    "mxnet_flight_dumps_total",
    "Flight-recorder timeline dumps by reason (manual = flight.dump() "
    "call, anomaly = slow-phase watchdog trip [k x EWMA, "
    "MXNET_FLIGHT_SLOW_FACTOR], signal = SIGUSR2, oom = device "
    "out-of-memory post-mortem via memory.oom_guard).  A climbing "
    "anomaly "
    "count is the page-the-oncall signal that steps/requests keep "
    "blowing their own baseline — each dump under MXNET_FLIGHT_DIR "
    "holds the timeline of the moments before it")
MEMORY_LEDGER_BYTES = Gauge(
    "mxnet_memory_ledger_bytes",
    "Tracked live bytes by ledger tag and space (observability.memory; "
    "bounded tag set — param/grad/output/executor/optimizer_state/"
    "grad_bucket/compression_residual/serve_weights/kvstore/prefetch/"
    "data/checkpoint_host/supervisor_snapshot, space=device|host "
    "[host = checkpoint and supervisor snapshot twins], and _untagged "
    "for the unattributed remainder).  Refreshed at export time from "
    "the weakref ledger, never on the hot path")
SUPERVISOR_SNAPSHOTS = Counter(
    "mxnet_supervisor_snapshots_total",
    "Rolling host snapshots the TrainingSupervisor took (every "
    "MXNET_SUPERVISE_SNAPSHOT_STEPS) — the donation-safe restore points "
    "transient-step retries rebuild from")
SUPERVISOR_RETRIES = Counter(
    "mxnet_supervisor_retries_total",
    "Supervised training steps re-executed after a transient failure "
    "(restore last snapshot -> replay window -> retry).  A climbing "
    "count with training still progressing is the supervisor doing its "
    "job; pair with faults_injected to tell chaos from real faults")
SUPERVISOR_REWINDS = Counter(
    "mxnet_supervisor_rewinds_total",
    "Snapshot restores performed by the TrainingSupervisor, by reason "
    "(retry = transient-step recovery, divergence = "
    "MXNET_SUPERVISE_ON_DIVERGE=rewind)")
SUPERVISOR_WATCHDOG_TRIPS = Counter(
    "mxnet_supervisor_watchdog_trips_total",
    "Training watchdog firings by kind (divergence = "
    "MXNET_SUPERVISE_DIVERGE_PATIENCE consecutive nonfinite losses, "
    "stall = a step blew its EWMA-derived deadline).  Each trip leaves "
    "one rate-limited post-mortem (report + flight ring) under "
    "MXNET_FLIGHT_DIR")
SUPERVISOR_LAST_SNAPSHOT_STEP = Gauge(
    "mxnet_supervisor_last_snapshot_step",
    "Step id of the TrainingSupervisor's most recent rolling host "
    "snapshot — how far back a donation-safe retry would rewind")
PREFETCH_RESPAWNS = Counter(
    "mxnet_prefetch_respawns_total",
    "AsyncPrefetcher worker threads respawned after a transient IO "
    "error (one respawn per prefetcher lifetime; a second transient "
    "surfaces to the consumer)")
DATA_RECORDS_SKIPPED = Counter(
    "mxnet_data_records_skipped_total",
    "Corrupt input records skipped by the prefetcher's "
    "MXNET_DATA_SKIP_BUDGET (typed DataSkipBudgetError on exhaustion)")
def _goodput_ratio() -> float:
    """Export-time pull of the goodput fraction from the run ledger
    (lazy/guarded — a scrape must never fail because of it; 0.0 until
    any span is attributed)."""
    try:
        from . import goodput as _gp
        if not _gp.ENABLED:
            return 0.0
        return float(_gp.ratio())
    except Exception:  # noqa: BLE001
        return 0.0


GOODPUT_RATIO = Gauge(
    "mxnet_goodput_ratio",
    "Fraction (0..1) of this run's wall-clock attributed to useful "
    "compute (flight trainer_step/whole_step/serve_dispatch spans) by "
    "the goodput ledger (observability.goodput) — the rest "
    "is badput (mxnet_badput_seconds_total) or unattributed.  Computed "
    "at export",
    fn=lambda: _goodput_ratio())
BADPUT_SECONDS = Counter(
    "mxnet_badput_seconds_total",
    "Wall-clock seconds lost to each badput class, by reason "
    "(data_wait / checkpoint_block / retry_replay / rewind / recompile "
    "/ eviction_churn / stall / shed — the closed goodput taxonomy)")
SLO_BURN = Counter(
    "mxnet_slo_burn_total",
    "Rate-limited SLO burn firings, by slo (goodput = run goodput %% "
    "fell below MXNET_SLO_GOODPUT_PCT, serve_p99 = sliding-window "
    "serve p99 exceeded MXNET_SLO_SERVE_P99_MS).  Each firing also "
    "warns, journals an slo_burn entry, and fails the slo_burn "
    "readyz() check until the window recovers")


def _introspect_mfu(key: str) -> float:
    """Export-time pull of one MFU/roofline field from the introspector
    (0.0 until a counted step program and a step time exist)."""
    try:
        from . import introspect as _int
        if not _int.ENABLED:
            return 0.0
        return float(_int.mfu().get(key) or 0.0)
    except Exception:  # noqa: BLE001
        return 0.0


MFU = Gauge(
    "mxnet_mfu",
    "Model flops utilization of the training step, 0..1: counted flops "
    "per step / the card's step time (CUDA events around the replay; the "
    "flight recorder's EWMA off the card) / the peak for the card and "
    "the step's compute dtype (MXNET_PEAK_FLOPS overrides).  Computed at "
    "export",
    fn=lambda: _introspect_mfu("mfu"))
STEP_FLOPS_PER_S = Gauge(
    "mxnet_step_flops_per_s",
    "Achieved flops/s of the training step (counted flops / step time), "
    "the roofline's y-axis.  Computed at export",
    fn=lambda: _introspect_mfu("flops_per_s"))
STEP_BYTES_PER_S = Gauge(
    "mxnet_step_bytes_per_s",
    "Counted bytes per step (each unfused op's inputs and outputs) / step "
    "time.  Computed at export",
    fn=lambda: _introspect_mfu("bytes_per_s"))
STEP_ARITH_INTENSITY = Gauge(
    "mxnet_step_arithmetic_intensity",
    "Counted flops per counted byte of the training step, the roofline's "
    "x-axis.  Computed at export",
    fn=lambda: _introspect_mfu("arithmetic_intensity"))




def _hbm_stats_all() -> List[dict]:
    """Per-CUDA-device numbers of the caching allocator
    (``torch.cuda.memory_stats``: bytes_in_use = allocated bytes,
    peak_bytes_in_use, bytes_reserved) and of the card
    (``torch.cuda.mem_get_info``: bytes_free, bytes_limit = the card's
    total), the JAX package's key names where they have one.  Empty on a
    machine without CUDA or before CUDA is initialized (reading them
    never initializes it)."""
    out = []
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return out
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
            out.append({
                "device": str(i), "platform": "gpu",
                "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(
                    s.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
                "num_ooms": int(s.get("num_ooms", 0)),
                "bytes_free": int(free), "bytes_limit": int(total)})
    except Exception:  # noqa: BLE001 — an export must never fail
        pass
    return out


def hbm_stats() -> List[dict]:
    return _hbm_stats_all()


def _hbm_in_use_total() -> float:
    return float(sum(s.get("bytes_in_use", 0) for s in _hbm_stats_all()))


HBM_BYTES_IN_USE = Gauge(
    "mxnet_hbm_bytes_in_use",
    "Sum of the CUDA caching allocator's allocated bytes over the local "
    "cards (sampled at export)",
    fn=_hbm_in_use_total)


def _sum_by_label(counter: Counter, label: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in list(counter._children.items()):
        key = dict(k).get(label, "_")
        out[key] = out.get(key, 0.0) + v
    return out


def _flight_snapshot() -> dict:
    """snapshot()["flight"]: ring/watchdog state + per-phase p50/p99 +
    slowest-record exemplars (lazy/guarded)."""
    try:
        from . import flight as _fl
        return _fl.snapshot_summary()
    except Exception:  # noqa: BLE001
        return {"enabled": False}


def _memory_snapshot() -> dict:
    """snapshot()["memory"]: per-tag live/peak bytes, attribution pct,
    untagged remainder, budget + OOM state (lazy/guarded)."""
    try:
        from . import memory as _mem
        return _mem.snapshot_summary()
    except Exception:  # noqa: BLE001
        return {"enabled": False}


def _programs_snapshot() -> dict:
    """snapshot()["programs"]: per-program flops/bytes, MFU and the perf
    sentinel's state (lazy/guarded)."""
    try:
        from . import introspect as _int
        return _int.snapshot_summary()
    except Exception:  # noqa: BLE001
        return {"enabled": False}


def _goodput_snapshot() -> dict:
    """snapshot()["goodput"]: per-class seconds/events, goodput %,
    unattributed slack, SLO targets + burn state, and the run journal's
    id/path (lazy/guarded)."""
    try:
        from . import goodput as _gp
        out = _gp.report()
        if out.get("enabled"):
            out["slo"] = _gp.slo_state()
        from . import journal as _jr
        out["run_id"] = _jr.run_id()
        out["journal_path"] = _jr.path()
        return out
    except Exception:  # noqa: BLE001
        return {"enabled": False}


def _journal_snapshot() -> dict:
    try:
        from . import journal as _jr
        return {"enabled": _jr.ENABLED, "run_id": _jr.run_id(),
                "path": _jr.path()}
    except Exception:  # noqa: BLE001
        return {"enabled": False}


def _analysis_snapshot() -> dict:
    """snapshot()["analysis"]: sanitizer state + violation counters."""
    out = {"lock_order_violations": ANALYSIS_LOCK_VIOLATIONS.value,
           "sync_violations": ANALYSIS_SYNC_VIOLATIONS.value}
    try:
        from ..analysis import sanitizer as _san
        out.update(_san.state())
    except Exception:  # noqa: BLE001
        out["enabled"] = False
    return out


def snapshot() -> dict:
    """One JSON-able dict: dispatch counts and gauges, the serving
    numbers (with the registry's and decode's), and the flight, memory,
    goodput, journal, programs, analysis, supervisor, prefetch and
    checkpoint sections (the JAX package's ``snapshot()`` keys for the parts the
    port has), with the CUDA allocator's numbers under ``hbm``."""
    return {
        "dispatch_counts": dispatch_counts(),
        "fit_step_dispatches": FIT_STEP_DISPATCHES.get(),
        "trainer_step_dispatches": TRAINER_STEP_DISPATCHES.get(),
        "superstep_dispatches": SUPERSTEP_DISPATCHES.get(),
        "serving": {
            "requests": SERVE_REQUESTS.value,
            "batches": SERVE_BATCHES.value,
            "compiles": SERVE_COMPILES.value,
            "queue_depth": SERVE_QUEUE_DEPTH.get(),
            "padding_waste": SERVE_PADDING_WASTE.get(),
            "coalesced_rows": SERVE_COALESCED_ROWS.get(),
            "latency_ms_mean": SERVE_LATENCY_SECONDS.mean * 1e3,
            "admitted": SERVE_ADMITTED.value,
            "shed": SERVE_SHED.value,
            "expired": SERVE_EXPIRED.value,
            "goodput": {dict(k).get("tenant", "_"): v for k, v in
                        sorted(list(SERVE_GOODPUT._children.items()))},
            "ready": SERVE_READY.get(),
            "ready_transitions": SERVE_READY_TRANSITIONS.value,
            "readmissions": SERVE_READMITS.value,
            "reload_failures": SERVE_RELOAD_FAILURES.value,
            "faults_injected": FAULTS_INJECTED.value,
            "evictions": _sum_by_label(SERVE_EVICTIONS, "kind"),
            "resident_models": SERVE_RESIDENT_MODELS.get(),
            "model_hbm_bytes": {
                dict(k).get("model", "_"): v for k, v in
                sorted(list(SERVE_MODEL_HBM_BYTES._children.items()))},
            "latency_exemplars": SERVE_LATENCY_SECONDS.exemplars(),
            "decode": {
                "steps": DECODE_STEPS.value,
                "tokens": DECODE_TOKENS.value,
                "inflight": DECODE_INFLIGHT.get(),
                "kv_page_occupancy": DECODE_KV_OCCUPANCY.get(),
                "tokens_per_s": DECODE_TOKENS_PER_S.get(),
                "kv_evictions": DECODE_KV_EVICTIONS.value,
            },
        },
        "data_wait_ms_total": DATA_WAIT_SECONDS.sum * 1e3,
        "data_wait_ms_mean": DATA_WAIT_SECONDS.mean * 1e3,
        "prefetch_wait_ms_total": PREFETCH_WAIT_SECONDS.sum * 1e3,
        "flight": _flight_snapshot(),
        "goodput": _goodput_snapshot(),
        "journal": _journal_snapshot(),
        "memory": _memory_snapshot(),
        "programs": _programs_snapshot(),
        "analysis": _analysis_snapshot(),
        "supervisor": {
            "snapshots": SUPERVISOR_SNAPSHOTS.value,
            "last_snapshot_step": SUPERVISOR_LAST_SNAPSHOT_STEP.get(),
            "retries": SUPERVISOR_RETRIES.value,
            "rewinds": {dict(k).get("reason", "_"): v for k, v in
                        sorted(list(SUPERVISOR_REWINDS._children.items()))},
            "watchdog_trips": {
                dict(k).get("kind", "_"): v for k, v in
                sorted(list(SUPERVISOR_WATCHDOG_TRIPS._children.items()))},
            "prefetch_respawns": PREFETCH_RESPAWNS.value,
            "data_records_skipped": DATA_RECORDS_SKIPPED.value,
        },
        "prefetch": {
            "wait_ms_total": PREFETCH_WAIT_SECONDS.sum * 1e3,
            "waits": PREFETCH_WAIT_SECONDS.count,
            "respawns": PREFETCH_RESPAWNS.value,
            "records_skipped": DATA_RECORDS_SKIPPED.value,
        },
        "checkpoint": {
            "last_step": CHECKPOINT_LAST_STEP.get(),
            "saves": CHECKPOINT_SAVE_SECONDS.count,
            "save_ms_mean": CHECKPOINT_SAVE_SECONDS.mean * 1e3,
            "save_blocked_ms_mean":
                CHECKPOINT_SAVE_BLOCKED_SECONDS.mean * 1e3,
            "restores": CHECKPOINT_RESTORE_SECONDS.count,
            "restore_ms_mean": CHECKPOINT_RESTORE_SECONDS.mean * 1e3,
            "bytes_written": CHECKPOINT_BYTES_WRITTEN.value,
            "failures": CHECKPOINT_FAILURES.value,
        },
        "faults_injected": _sum_by_label(FAULTS_INJECTED, "site"),
        "hbm": hbm_stats(),
    }


def _refresh_export_gauges() -> None:
    """Pull-style gauges refresh here so the render paths export fresh
    values even when ``snapshot()`` never runs (lazy/guarded)."""
    try:
        from . import memory as _mem
        _mem.refresh_gauge()
    except Exception:  # noqa: BLE001
        pass


def render_prometheus() -> str:
    _refresh_export_gauges()
    return REGISTRY.render_prometheus()


def render_json() -> str:
    _refresh_export_gauges()
    return REGISTRY.render_json()
