"""Metrics registry: counters, gauges, histograms with labels, the
Prometheus-text / JSON exporters, and the serving metrics.

The counterpart of the part of ``mxnet_tpu/observability/metrics.py`` that
the serving tier writes: the same primitives, the same ``SERVE_*`` metric
names and labels, and ``snapshot()["serving"]``.  Every hook reads the
module global ``ENABLED`` first, so ``MXNET_METRICS_ENABLED=0`` costs one
boolean test per hook; metrics are module-level objects created once at
import and never looked up by name on a hot path.
"""
from __future__ import annotations

import json as _json
import threading
from typing import Dict, List, Optional, Tuple

from ..base import getenv

ENABLED: bool = getenv("MXNET_METRICS_ENABLED", True)


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


# One shared mutation lock: hooks fire from request threads and from the
# serving dispatcher threads; an unguarded read-modify-write would drop
# increments.
_MUT_LOCK = threading.Lock()


def _label_key(labels: dict) -> Tuple:
    return tuple(sorted(labels.items()))


class Metric:
    """Base: name + help + label-set -> value(s)."""

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
    """Monotonic counter; labeled children live in a dict keyed by sorted
    label items."""

    kind = "counter"

    def __init__(self, name, help="", registry=None):
        self._value = 0.0
        self._children: Dict[Tuple, float] = {}
        super().__init__(name, help, registry)

    def inc(self, value: float = 1.0, **labels) -> None:
        with _MUT_LOCK:
            if labels:
                k = _label_key(labels)
                self._children[k] = self._children.get(k, 0.0) + value
            else:
                self._value += value

    @property
    def value(self) -> float:
        return self._value + sum(list(self._children.values()))

    def get(self, **labels) -> float:
        return self._children.get(_label_key(labels), 0.0) if labels \
            else self._value

    def reset(self) -> None:
        self._value = 0.0
        self._children.clear()

    def fold_label(self, label: str, value, replacement) -> None:
        """Merge every child whose ``label`` equals ``value`` into the same
        label set with ``label=replacement`` (bounds label cardinality and
        keeps the total)."""
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
    """Point-in-time value, optionally one per label set."""

    kind = "gauge"

    def __init__(self, name, help="", registry=None):
        self._value = 0.0
        self._children: Dict[Tuple, float] = {}
        super().__init__(name, help, registry)

    def set(self, value: float, **labels) -> None:
        if labels:
            with _MUT_LOCK:
                self._children[_label_key(labels)] = float(value)
        else:
            self._value = float(value)

    def get(self, **labels) -> float:
        return self._children.get(_label_key(labels), 0.0) if labels \
            else self._value

    def remove(self, **labels) -> None:
        """Drop one labeled child (keeps per-label cardinality bounded)."""
        with _MUT_LOCK:
            self._children.pop(_label_key(labels), None)

    def reset(self) -> None:
        self._value = 0.0
        self._children.clear()

    def samples(self):
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
    """Fixed-bucket histogram (cumulative ``le`` buckets on export, like
    Prometheus); tracks sum and count."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=_DEFAULT_BUCKETS,
                 registry=None):
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._count = 0
        super().__init__(name, help, registry)

    def observe(self, value: float) -> None:
        with _MUT_LOCK:
            self._sum += value
            self._count += 1
            self._counts[next((i for i, b in enumerate(self.buckets)
                               if value <= b), len(self.buckets))] += 1

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

    def samples(self):
        out, cum = [], 0
        for b, c in zip(self.buckets, self._counts):
            cum += c
            out.append((self.name + "_bucket", (("le", repr(float(b))),),
                        cum))
        cum += self._counts[-1]
        out.append((self.name + "_bucket", (("le", "+Inf"),), cum))
        out.append((self.name + "_sum", (), self._sum))
        out.append((self.name + "_count", (), self._count))
        return out


class MetricsRegistry:
    """Name -> Metric; collect/export/reset over the whole set."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric: Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    def render_prometheus(self) -> str:
        lines = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for series, labels, value in m.samples():
                sel = ""
                if labels:
                    sel = "{" + ",".join(f'{k}="{v}"' for k, v in labels) \
                        + "}"
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
                for _, labels, value in m.samples():
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


def snapshot() -> dict:
    """One JSON-able dict of the serving numbers (the JAX package's
    ``snapshot()["serving"]`` keys that the port's serving tier writes)."""
    return {
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
        },
    }


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def render_json() -> str:
    return REGISTRY.render_json()
