"""Runtime-wide observability (parity: ``mxnet_tpu/observability``).

  - ``metrics`` — the process-wide registry of counters / gauges /
    histograms with Prometheus-text and JSON exporters; ``snapshot()``
    carries the serving, flight, memory, goodput, journal, analysis,
    supervisor, prefetch and checkpoint sections, and ``hbm_stats()`` the
    CUDA allocator's numbers.
  - ``tracing`` — ``trace_span`` / ``step_span`` / ``annotate``: spans in
    the python-side Chrome trace and, as ``torch.profiler.record_function``
    and NVTX ranges, in the ``torch.profiler`` trace beside the kernels.
  - ``flight`` — the always-on flight recorder: ``phase_span`` rings,
    trace ids, the slow-phase watchdog, ``SIGUSR2`` and Chrome-trace
    ``dump()``; ``timeline`` renders it.
  - ``memory`` — the device-memory ledger: weakref-tracked bytes by
    ``memory_scope`` tag, the ``MXNET_HBM_BUDGET_MB`` watchdog,
    ``ensure_headroom``, and the ``oom_guard`` post-mortem.
  - ``goodput`` and ``journal`` — the run's badput account and its
    crash-durable JSONL journal (``MXNET_RUN_DIR``); ``report`` reads the
    journal back (``python -m mxnet_tpu_torch.observability.report``).

  - ``introspect`` — the program introspector: flops and bytes counted
    per program by a ``TorchDispatchMode`` (there is no HLO), per-layer
    attribution through ``layer_scope``, MFU against the H100's peak over
    the card's step time (CUDA events around each replay), and the
    persisted perf-regression sentinel.

Every hot-path hook is one module-global boolean test when its layer is
off (``MXNET_METRICS_ENABLED``, ``MXNET_FLIGHT``, ``MXNET_MEMORY_LEDGER``,
``MXNET_GOODPUT``, ``MXNET_RUN_DIR``).
"""
from __future__ import annotations

from . import metrics
from . import tracing
from . import goodput
from . import journal
from . import flight
from . import timeline
from . import memory
from . import introspect
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      enabled, enable, disable, snapshot, render_prometheus,
                      render_json, hbm_stats, dispatch_counts)
from .tracing import trace_span, step_span, annotate
from .flight import phase_span, trace_scope, new_trace_id
from .memory import memory_scope, oom_guard, DeviceMemoryError, HBMBudgetError

__all__ = [
    "metrics", "tracing", "flight", "timeline", "memory",
    "goodput", "journal", "introspect", "dispatch_counts",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "enabled", "enable", "disable", "snapshot",
    "render_prometheus", "render_json", "hbm_stats",
    "trace_span", "step_span", "annotate",
    "phase_span", "trace_scope", "new_trace_id",
    "memory_scope", "oom_guard", "DeviceMemoryError", "HBMBudgetError",
]
