"""Autotune decisions and the K-step superstep (parity:
``mxnet_tpu/autotune/``).

- ``decisions``: knobs measured once per (model signature, platform) and
  persisted as JSON, read by the trainer (``bucket_size_mb``) and the
  superstep (``superstep_k``) when their environment variables are unset.
  The platform is the card's name (``torch.cuda.get_device_name()``).
- ``superstep``: ``SuperStepCompiler`` runs K whole training steps as one
  captured CUDA graph over K staged batches.

Not ported yet: the sweep tuner (``sweep.py``, ``tune``) and its command
line (``__main__.py``), and the serving hooks that read decisions
(ROADMAP.md).
"""
from __future__ import annotations

from . import decisions
from . import superstep
from .superstep import SuperStepCompiler

__all__ = ["SuperStepCompiler", "decisions", "superstep"]
