"""mxnet_tpu_torch.serving — the inference fast path (parity:
``mxnet_tpu/serving``).

Three composable layers over a Symbol graph:

  - ``BucketSpec`` / ``buckets`` — the padded shape-bucket lattice
    (pow2-derived, ``MXNET_SERVE_BUCKETS`` / ``MXNET_SERVE_SEQ_BUCKETS``);
  - ``BucketedPredictor`` — one warmed entry per bucket (``warmup()``
    builds them all before traffic), requests padded on the host, valid
    rows sliced back;
  - ``MicroBatcher`` — concurrent requests coalesce into one
    covering-bucket dispatch (``MXNET_SERVE_MAX_WAIT_MS`` /
    ``MXNET_SERVE_MAX_BATCH``);
  - ``ResilientServer`` — per-tenant admission control with bounded
    priority queues (``MXNET_SERVE_MAX_QUEUE``), deadline-aware
    scheduling and load shedding (typed ``Overloaded`` /
    ``DeadlineExceeded``), ``healthz()`` / ``readyz()``.

The multi-model ``ModelRegistry`` and the continuous-batching
``DecodeEngine`` of the JAX package are not ported yet (ROADMAP.md, queue
item 2).
"""
from . import buckets
from .buckets import (BucketSpec, covering_bucket, pad_to_shape,
                      parse_bucket_env, pow2_buckets)
from .predictor import BucketedPredictor, ModelEvictedError
from .batcher import (BatcherClosedError, BatcherDeadError,
                      GenerativeRouteError, MicroBatcher, stack_requests)
from . import resilience
from .resilience import DeadlineExceeded, Overloaded, ResilientServer

__all__ = ["BucketSpec", "BucketedPredictor", "MicroBatcher",
           "ResilientServer", "Overloaded", "DeadlineExceeded",
           "BatcherClosedError", "BatcherDeadError", "GenerativeRouteError",
           "ModelEvictedError", "buckets", "resilience", "covering_bucket",
           "pad_to_shape", "parse_bucket_env", "pow2_buckets",
           "stack_requests"]
