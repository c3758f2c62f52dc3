"""Autotune decisions and the K-step superstep (parity:
``mxnet_tpu/autotune/``).

- ``decisions``: knobs measured once per (model signature, platform) and
  persisted as JSON, read by the trainer (``bucket_size_mb``) and the
  superstep (``superstep_k``) when their environment variables are unset.
  The platform is the card's name (``torch.cuda.get_device_name()``).
- ``superstep``: ``SuperStepCompiler`` runs K whole training steps as one
  captured CUDA graph over K staged batches.
- ``sweep``: the measured tuner (``tune``): paired-interleave sweeps of
  the superstep's K and the bucket size, the serving lattice from observed
  traffic and the batcher's hold window from the dispatch EWMA, persisted
  once per (model, card); ``python -m mxnet_tpu_torch.autotune --smoke``
  drives it.  ``serving.buckets`` and ``serving.batcher`` read the serving
  decisions.
"""
from __future__ import annotations

from . import decisions
from . import superstep
from . import sweep
from .superstep import SuperStepCompiler
from .sweep import tune

__all__ = ["SuperStepCompiler", "decisions", "superstep", "sweep", "tune"]
