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

  - ``ModelRegistry`` — N predictors in one process under one
    device-memory budget: LRU eviction (decode KV pages, then cold
    buckets, then cold models' weights), readmission from the host
    payload, the typed degradation ladder (``ModelUnavailable``);
  - ``DecodeEngine`` — continuous-batching generative decode over a
    paged KV lattice, one CUDA-graph replay per decode step
    (``decode.ToyLM``), EDF shedding at step granularity (``StepEDF``).
"""
from . import buckets
from .buckets import (BucketSpec, covering_bucket, pad_to_shape,
                      parse_bucket_env, pow2_buckets)
from .predictor import BucketedPredictor, ModelEvictedError
from .batcher import (BatcherClosedError, BatcherDeadError,
                      GenerativeRouteError, MicroBatcher, stack_requests)
from . import resilience
from .resilience import (DeadlineExceeded, Overloaded, ResilientServer,
                         StepEDF)
from . import decode
from .decode import (DecodeClosedError, DecodeEngine, SequenceEvicted,
                     ToyLM)
from . import registry
from .registry import (DEGRADATION_LADDER, EVICT_POLICIES, ModelRegistry,
                       ModelUnavailable)

__all__ = ["BucketSpec", "BucketedPredictor", "MicroBatcher",
           "ResilientServer", "Overloaded", "DeadlineExceeded",
           "BatcherClosedError", "BatcherDeadError", "GenerativeRouteError",
           "ModelEvictedError", "buckets", "resilience", "covering_bucket",
           "pad_to_shape", "parse_bucket_env", "pow2_buckets",
           "stack_requests", "StepEDF", "decode", "DecodeEngine", "ToyLM",
           "SequenceEvicted", "DecodeClosedError", "registry",
           "ModelRegistry", "ModelUnavailable", "EVICT_POLICIES",
           "DEGRADATION_LADDER"]
