"""Runtime analysis (parity: ``mxnet_tpu/analysis/__init__.py``, its
runtime side): the concurrency sanitizer's lock factories, the lock-order
graph with ``LockOrderError``, and ``no_sync()`` regions with
``check_sync``.  ``MXNET_SANITIZE=1`` arms them.

The static checkers, the dataflow pass and the compiled-program audit of
the JAX package (``checkers.py``, ``dataflow.py``, ``program_audit.py``)
are not ported (ROADMAP.md, queue item 7)."""
from __future__ import annotations

from . import sanitizer
from .sanitizer import (DonatedBufferError, LockOrderError, SyncViolation,
                        check_sync, hot_path, make_condition, make_lock,
                        make_rlock, no_sync, sanitized)

__all__ = ["hot_path", "no_sync", "sanitizer", "sanitized",
           "make_lock", "make_rlock", "make_condition", "check_sync",
           "LockOrderError", "SyncViolation", "DonatedBufferError"]
