"""Observability (parity: mxnet_tpu/observability): the metrics registry
and the serving metrics.  Tracing, the flight recorder, the memory ledger,
introspection and goodput come later (ROADMAP.md, queue item 5)."""
from . import metrics
from .metrics import snapshot
