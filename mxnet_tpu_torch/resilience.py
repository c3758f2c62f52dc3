"""Training-side fault taxonomy: typed errors, failure classification,
post-mortem dumps (parity: ``mxnet_tpu/resilience.py``).

Production training dies in three distinct ways, and the right reaction
differs per class:

  ==============  =========================================================
  **transient**   The device or its runtime hiccuped (UNAVAILABLE, an RPC
                  deadline, injected chaos).  The step is re-executable:
                  the ``TrainingSupervisor`` restores its rolling host
                  snapshot and replays.
  **oom**         Device memory is gone (``DeviceMemoryError`` /
                  ``HBMBudgetError`` from the memory ledger, or
                  ``torch.cuda.OutOfMemoryError``).  Retrying the same
                  step re-OOMs; propagate with the post-mortem attached.
  **permanent**   A trace/user error (shape bug, ineligible op, NaN in
                  user code), or a sticky CUDA error ("illegal memory
                  access", "device-side assert triggered", "unspecified
                  launch failure"): after one, the process's CUDA context
                  is unusable and a retry in the same process would
                  compute on a corrupt context.  Propagate immediately.
  ==============  =========================================================

``classify(exc)`` maps an exception to one of these three strings;
``post_mortem(reason, ...)`` writes the rate-limited black-box report
(flight ring + memory ledger) the watchdogs attach to their typed
errors.  The typed errors live here — not in ``gluon/supervisor.py`` —
because the data pipeline (``gluon/data/prefetcher.py``,
``io.PrefetchingIter``) and the fault injector need them without
importing gluon.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, Optional

from .base import MXNetError, atomic_write, unique_path

log = logging.getLogger(__name__)

__all__ = ["TRANSIENT", "OOM", "PERMANENT", "classify",
           "DeviceUnavailableError", "DivergenceError",
           "TrainingStalledError", "StepRetriesExhausted",
           "DataCorruptionError", "DataSkipBudgetError",
           "post_mortem", "last_post_mortem", "reset"]

#: classification buckets ``classify`` returns
TRANSIENT = "transient"
OOM = "oom"
PERMANENT = "permanent"


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------
class DeviceUnavailableError(MXNetError):
    """The accelerator (or its RPC tunnel) reported UNAVAILABLE — the
    transient device-loss class (also what the ``device.unavailable``
    faultinject site raises).  Always classified transient."""


class DivergenceError(MXNetError):
    """The divergence watchdog tripped: ``MXNET_SUPERVISE_DIVERGE_PATIENCE``
    consecutive nonfinite losses.  Carries ``step`` and the post-mortem
    paths in ``report``."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 report: Optional[dict] = None):
        super().__init__(msg)
        self.step = step
        self.report = report or {}


class TrainingStalledError(MXNetError):
    """The stall watchdog tripped: a step exceeded its EWMA-derived
    deadline and the device is presumed wedged.  Carries ``step``,
    ``timeout_s``, and the post-mortem paths in ``report``."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 report: Optional[dict] = None):
        super().__init__(msg)
        self.step = step
        self.timeout_s = timeout_s
        self.report = report or {}


class StepRetriesExhausted(MXNetError):
    """A transient step failure survived every donation-safe retry
    (``MXNET_SUPERVISE_RETRIES``).  ``__cause__`` chains the last
    underlying transient error."""

    def __init__(self, msg: str, step: Optional[int] = None):
        super().__init__(msg)
        self.step = step


class DataCorruptionError(MXNetError):
    """One input record could not be decoded (bit-rot, truncated
    download, bad serialization).  The prefetcher's skip budget
    (``MXNET_DATA_SKIP_BUDGET``) consumes these instead of killing the
    epoch; raise it from custom datasets/decoders to opt in."""


class DataSkipBudgetError(MXNetError):
    """The corrupt-record skip budget is exhausted — the input data is
    damaged beyond the configured tolerance, which is an operator
    problem, not a record problem."""


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------
# substrings that mark a device/RPC error as transient when the type
# alone can't (status phrases inside a runtime error's text)
_TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
                     "CANCELLED", "connection reset", "socket closed",
                     "failed to connect")

# CUDA's sticky errors: once one is raised the context is corrupt and
# every later call in this process fails, so no retry can help
_STICKY_CUDA_MARKERS = ("illegal memory access",
                        "device-side assert triggered",
                        "unspecified launch failure",
                        "misaligned address", "illegal instruction",
                        "cudaErrorIllegalAddress", "cudaErrorAssert",
                        "cudaErrorLaunchFailure")

# the caching allocator's out-of-memory text (torch.cuda.OutOfMemoryError
# and the RuntimeError older PyTorch raised)
_CUDA_OOM_MARKERS = ("CUDA out of memory", "cudaErrorMemoryAllocation")


def classify(exc: BaseException) -> str:
    """Map a step failure to ``TRANSIENT`` / ``OOM`` / ``PERMANENT``.

    Rules (first match wins):

    * ``DeviceMemoryError`` / ``HBMBudgetError`` → ``oom`` — the typed
      re-raise ``memory.oom_guard`` produces after its own post-mortem;
      ``torch.cuda.OutOfMemoryError`` and the allocator's "CUDA out of
      memory" text → ``oom`` too.
    * A sticky CUDA error ("illegal memory access", "device-side assert
      triggered", "unspecified launch failure", ...) → ``permanent``:
      the CUDA context is corrupt for the rest of the process.
    * ``DeviceUnavailableError``, ``faultinject.InjectedFault``,
      ``OSError``/``IOError``/``ConnectionError``/``TimeoutError`` →
      ``transient``.  (Note: the *checkpoint* retry loop deliberately
      treats ``InjectedFault`` as non-retryable to exercise retry
      exhaustion; the supervisor taxonomy classifies it transient so
      ``MXNET_FAULT_PLAN`` raise rules model recoverable device faults.)
    * Any exception whose text carries a transient status phrase
      (UNAVAILABLE, DEADLINE_EXCEEDED, ...) → ``transient``.
    * Everything else → ``permanent`` (trace/user errors: retrying the
      same program on the same data cannot succeed).
    """
    from .observability.memory import DeviceMemoryError, HBMBudgetError
    if isinstance(exc, (DeviceMemoryError, HBMBudgetError)):
        return OOM
    text = f"{type(exc).__name__}: {exc}"
    if type(exc).__name__ == "OutOfMemoryError" or \
            any(m in text for m in _CUDA_OOM_MARKERS):
        return OOM
    if any(m in text for m in _STICKY_CUDA_MARKERS):
        return PERMANENT
    if isinstance(exc, (DataCorruptionError, DataSkipBudgetError)):
        # damaged *data* is not a retryable *device* condition: replaying
        # the same record re-fails, so the prefetcher's skip budget — not
        # the supervisor's snapshot retry — is the handler
        return PERMANENT
    if isinstance(exc, DeviceUnavailableError):
        return TRANSIENT
    from .faultinject import InjectedFault
    if isinstance(exc, InjectedFault):
        return TRANSIENT
    if isinstance(exc, (OSError, ConnectionError, TimeoutError)):
        return TRANSIENT
    if any(m in text for m in _TRANSIENT_MARKERS):
        return TRANSIENT
    return PERMANENT


# ---------------------------------------------------------------------------
# post-mortem dumps
# ---------------------------------------------------------------------------
#: minimum seconds between post-mortem dumps per reason (tests set 0) —
#: the same never-spam-the-disk posture as flight.AUTO_DUMP_MIN_S /
#: memory.OOM_DUMP_MIN_S
POST_MORTEM_MIN_S = 30.0

_pm_lock = threading.Lock()
_last_pm_t: Dict[str, float] = {}
_last_pm: Dict[str, dict] = {}


def post_mortem(reason: str, step: Optional[int] = None,
                detail: Optional[dict] = None) -> Optional[dict]:
    """Write the training black-box report for ``reason`` ("divergence",
    "stall", "preempt", ...): one JSON post-mortem (failing step id,
    caller detail, memory ledger report, watchdog EWMAs) plus a flight-ring
    timeline dump, both under ``MXNET_FLIGHT_DIR``.  Rate-limited per
    reason by ``POST_MORTEM_MIN_S`` — a watchdog that keeps tripping
    produces exactly one dump per window, never a disk flood.  Returns
    ``{"report_path", "flight_path", ...}`` or ``None`` when
    rate-limited.  Runs inline (the callers are about to raise a typed
    error or rewind — not a hot path), and never raises itself."""
    now = time.monotonic()
    with _pm_lock:
        t = _last_pm_t.get(reason)
        if t is not None and now - t < POST_MORTEM_MIN_S:
            return None
        _last_pm_t[reason] = now
    info: dict = {"reason": reason, "step": step, "time": time.time()}
    if detail:
        info["detail"] = dict(detail)
    from .observability import flight as _flight
    from .observability import journal as _journal
    from .observability import memory as _memory
    if _journal.ENABLED:
        # cross-reference both ways: the report names its run + journal
        # and the journal names the report files
        info["run_id"] = _journal.run_id()
        info["journal_path"] = _journal.path()
    try:
        payload = dict(info)
        if _memory.ENABLED:
            payload["memory"] = _memory.report()
        payload["watch"] = _flight.watch_state()
        d = os.environ.get("MXNET_FLIGHT_DIR", ".") or "."
        os.makedirs(d, exist_ok=True)
        path = unique_path(d, f"postmortem-{reason}", ".json")
        atomic_write(path, json.dumps(payload, default=str))
        info["report_path"] = path
    except Exception as e:  # noqa: BLE001 — a failed dump must not mask
        log.warning("post-mortem report (%s) failed: %s", reason, e)
        info["report_path"] = None
    try:
        info["flight_path"] = _flight.dump(reason=reason) \
            if _flight.ENABLED else None
    except Exception as e:  # noqa: BLE001
        log.warning("post-mortem flight dump (%s) failed: %s", reason, e)
        info["flight_path"] = None
    log.warning("post-mortem (%s) at step %s: report=%s flight=%s",
                reason, step, info.get("report_path"),
                info.get("flight_path"))
    if _journal.ENABLED:
        _journal.emit("post_mortem", step=step, durable=True,
                      why=reason,
                      report_path=info.get("report_path"),
                      flight_path=info.get("flight_path"))
    with _pm_lock:
        _last_pm[reason] = info
    return info


def last_post_mortem(reason: str) -> Optional[dict]:
    """The most recent ``post_mortem`` result for ``reason`` (tests and
    operators; None when none fired)."""
    with _pm_lock:
        return dict(_last_pm[reason]) if reason in _last_pm else None


def reset() -> None:
    """Drop rate-limit windows and recorded post-mortems (tests)."""
    with _pm_lock:
        _last_pm_t.clear()
        _last_pm.clear()
