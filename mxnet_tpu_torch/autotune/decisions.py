"""Persisted autotune decisions (parity: ``mxnet_tpu/autotune/
decisions.py``): one JSON file per (signature, platform) under
``decisions_dir()`` (``MXNET_AUTOTUNE_DIR``, else ``autotune-decisions/``
beside ``MXNET_COMPILE_CACHE_DIR``), written atomically.  A signature is a
content hash of what the decision depends on (``model_signature`` of the
trainable parameters' shapes and dtypes), so a changed model misses and is
tuned again.  The platform is the card's name
(``torch.cuda.get_device_name()``), "cpu" without one.

An environment variable that names a knob (``KNOB_ENV``) always wins: a
consumer reads its own variable first and calls ``knob`` only when it is
unset.  Everything is off unless ``MXNET_AUTOTUNE`` is set, and then costs
one boolean test per consumer.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

from ..base import getenv
from ..ndarray.ndarray import write_atomic

logger = logging.getLogger("mxnet_tpu_torch.autotune")

#: the MXNET_AUTOTUNE switch
ENABLED: bool = bool(getenv("MXNET_AUTOTUNE", False))

_SCHEMA = 1

#: knob name -> the environment variable that overrides it
KNOB_ENV = {
    "superstep_k": "MXNET_SUPERSTEP_K",
    "bucket_size_mb": "MXNET_BUCKET_SIZE_MB",
    "serve_buckets": "MXNET_SERVE_BUCKETS",
    "serve_max_wait_ms": "MXNET_SERVE_MAX_WAIT_MS",
    "prefetch_depth": "MXNET_PREFETCH_DEPTH",
}

# (signature, platform) -> record or None; decisions do not change once
# written (store() refreshes its own entry)
_cache: Dict[tuple, Optional[dict]] = {}


def enabled() -> bool:
    return ENABLED


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def reset_cache() -> None:
    _cache.clear()


def decisions_dir() -> Optional[str]:
    """``MXNET_AUTOTUNE_DIR``, else ``autotune-decisions/`` beside
    ``MXNET_COMPILE_CACHE_DIR``; None keeps decisions in the process."""
    d = os.environ.get("MXNET_AUTOTUNE_DIR")
    if d:
        return d
    c = os.environ.get("MXNET_COMPILE_CACHE_DIR")
    return os.path.join(c, "autotune-decisions") if c else None


def _platform() -> str:
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


def _file_part(platform: str) -> str:
    """The platform as a file name part ("NVIDIA H100 80GB HBM3" has
    spaces)."""
    return "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in platform)


def model_signature(sig, extra=()) -> str:
    """Content hash of a parameter signature (tuples of (shape, dtype
    name)) and any further configuration the decision depends on."""
    return hashlib.sha1(
        repr((tuple(sig), tuple(extra))).encode()).hexdigest()[:16]


def decision_path(signature: str, platform: Optional[str] = None) \
        -> Optional[str]:
    d = decisions_dir()
    if d is None:
        return None
    return os.path.join(
        d, f"autotune-{signature}-{_file_part(platform or _platform())}"
           ".json")


def load(signature: str, platform: Optional[str] = None) -> Optional[dict]:
    """The decision record for (signature, platform), or None when there
    is none or it is corrupt (which warns and counts as none)."""
    plat = platform or _platform()
    ck = (signature, plat)
    if ck in _cache:
        return _cache[ck]
    path = decision_path(signature, plat)
    rec = None
    if path is not None and os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict) or data.get("schema") != _SCHEMA \
                    or not isinstance(data.get("knobs"), dict):
                raise ValueError("missing/invalid required fields")
            rec = data
        except Exception as e:  # noqa: BLE001 — a bad file is no decision
            logger.warning(
                "autotune: decision file %s is corrupt (%s) — ignored",
                path, e)
    _cache[ck] = rec
    return rec


def store(signature: str, knobs: Dict[str, Any], evidence=None,
          platform: Optional[str] = None) -> Optional[str]:
    """Persist a decision record atomically; returns its path (None when
    no directory is configured)."""
    plat = platform or _platform()
    path = decision_path(signature, plat)
    rec = {"schema": _SCHEMA, "signature": signature, "platform": plat,
           "knobs": dict(knobs), "evidence": dict(evidence or {}),
           "written_at": time.time()}
    _cache[(signature, plat)] = rec
    if path is None:
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_atomic(path, json.dumps(rec, indent=1, sort_keys=True).encode())
    logger.info("autotune: wrote decision %s (knobs %s)", path,
                sorted(knobs))
    return path


def knob(signature: str, name: str, default=None,
         platform: Optional[str] = None):
    """One knob's persisted value, or ``default`` (always ``default`` with
    ``MXNET_AUTOTUNE`` off).  Consumers check ``KNOB_ENV[name]`` first."""
    if not ENABLED:
        return default
    rec = load(signature, platform)
    if rec is None:
        return default
    return rec["knobs"].get(name, default)
