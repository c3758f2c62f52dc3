"""Goodput ledger: classify every second of a run into a fixed badput
taxonomy (parity: ``mxnet_tpu/observability/goodput.py``).

It answers the operator's question: what fraction of this run's
wall-clock was useful training, and where did the rest go?  Every second
of a training or serving run is attributed to exactly one class of a
small, fixed taxonomy:

  ==================  =====================================================
  ``compute``         useful work — flight's ``trainer_step`` /
                      ``whole_step`` / ``superstep`` / ``serve_dispatch``
                      spans; for a replayed CUDA graph the card's time of
                      the replay (the introspector's CUDA event pair),
                      since the span times only the host's enqueue
  ``data_wait``       input starvation — prefetch/batch-wait spans
  ``checkpoint_block``  synchronous checkpoint save time
  ``retry_replay``    supervisor snapshot-restore + window replay after
                      a transient step failure
  ``rewind``          supervisor divergence rewind (restore to the last
                      snapshot)
  ``recompile``       CUDA-graph capture time: the capturing call of
                      ``WholeStepCompiler``, ``SuperStepCompiler`` and
                      ``Module``'s fused step, and the bucket builds of
                      ``BucketedPredictor.warmup``, measured
  ``eviction_churn``  multi-model evict/readmit work
  ``stall``           wedged-device time the stall watchdog declared
  ``shed``            serving work refused/expired under pressure
  ``unattributed``    wall-clock no instrument claimed (the honesty row)
  ==================  =====================================================

Attribution is passive: ``flight.record()`` taps every completed span
into ``observe_span`` (one dict lookup on the hot path), supervisors
bracket their replay loops in ``replay_scope``, and discrete badput
events call ``attribute(reason, seconds)``.  ``report()`` renders the
per-class seconds + goodput %, ``metrics`` exports
``mxnet_goodput_ratio`` / ``mxnet_badput_seconds_total{reason}``, and
``timeline.py`` draws the cumulative badput counter track.

SLO burn monitors ride the same ledger: declared targets
(``MXNET_SLO_GOODPUT_PCT``, ``MXNET_SLO_SERVE_P99_MS``) are evaluated
over sliding windows and fire rate-limited warnings +
``mxnet_slo_burn_total{slo}``, journaled like every other lifecycle
event.

``MXNET_GOODPUT=0`` reduces every hook to one module-global boolean
test.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from typing import Dict, Optional

from ..base import getenv
from ..analysis.sanitizer import make_lock

log = logging.getLogger(__name__)

__all__ = ["ENABLED", "CLASSES", "observe_span", "attribute",
           "note_event", "replay_scope", "report", "start",
           "serve_latency_sample", "slo_state", "slo_burning",
           "maybe_fire_slo", "enable", "disable", "enabled",
           "configure", "reset",
           "SLO_GOODPUT_PCT", "SLO_SERVE_P99_MS"]

#: kill-switch; parsed once — the gate contract
ENABLED: bool = bool(getenv("MXNET_GOODPUT", True))

#: the complete, closed taxonomy — ``attribute`` folds anything else
#: into ``unattributed`` (warn-once) instead of growing the ledger
CLASSES = ("compute", "data_wait", "checkpoint_block", "retry_replay",
           "rewind", "recompile", "eviction_churn", "stall", "shed",
           "unattributed")

#: badput classes exported as ``mxnet_badput_seconds_total{reason}``
#: (compute is goodput; unattributed is derived, not accumulated)
_BADPUT_CLASSES = frozenset(CLASSES) - {"compute", "unattributed"}

#: flight span name -> taxonomy class.  Only TOP-LEVEL unit-of-work
#: spans appear here — nested phases (h2d/allreduce/fused_update inside
#: trainer_step) must NOT, or their seconds would double-count.
_SPAN_CLASS: Dict[str, str] = {
    "trainer_step": "compute",
    "whole_step": "compute",
    "superstep": "compute",
    "serve_dispatch": "compute",
    "prefetch_wait": "data_wait",
    "data_wait": "data_wait",
    "checkpoint_block": "checkpoint_block",
    "serve_evict": "eviction_churn",
    "serve_readmit": "eviction_churn",
}

# --- SLO targets (0 = monitor off; deliberately NOT gate-shaped) -----------
#: minimum acceptable goodput % over the run (e.g. 90.0)
SLO_GOODPUT_PCT: float = getenv("MXNET_SLO_GOODPUT_PCT", 0.0)
#: maximum acceptable serving p99 latency in ms over the sliding window
SLO_SERVE_P99_MS: float = getenv("MXNET_SLO_SERVE_P99_MS", 0.0)
#: sliding-window size for serve latency p99
SLO_WINDOW: int = 256
#: don't judge p99 on fewer samples than this
SLO_MIN_SAMPLES: int = 20
#: minimum seconds between burn firings per slo (tests set 0) — the
#: never-spam posture of flight.AUTO_DUMP_MIN_S / POST_MORTEM_MIN_S
SLO_BURN_MIN_S: float = 30.0
#: goodput SLO needs some run under its belt before it can burn
SLO_MIN_RUN_S: float = 5.0

_lock = make_lock("goodput.ledger")
_ledger: Dict[str, Dict[str, float]] = {}
_events: Dict[str, int] = {}
# run clock origin (time.monotonic); lazily set on first attribution so
# an idle import doesn't start the meter, explicitly set by start()
_run_started: Optional[float] = None
# process-global (NOT thread-local: the supervisor may run step_fn on a
# watchdog worker thread while replay_scope is held on the caller)
_replay_depth: int = 0
_warned_unknown: set = set()
#: compute spans whose seconds come from the card (CUDA events around a
#: replay, read a step later): the host span of such a step is skipped,
#: and ``observe_device`` books the card's time instead
_device_deferred: Dict[str, int] = {}

# SLO state: sliding serve-latency window + rate-limit timestamps.
# None sentinels, never 0.0 — time.monotonic() can be < SLO_BURN_MIN_S
# on a freshly booted machine.
_serve_lat_ms: deque = deque(maxlen=SLO_WINDOW)
_slo_last_fire: Dict[str, Optional[float]] = {}
_slo_burning: Dict[str, bool] = {}


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------
def _touch_clock_locked(now: float) -> None:
    global _run_started
    if _run_started is None:
        _run_started = now


def start() -> None:
    """Pin the run-clock origin to *now* (callers that want wall-clock
    accounting from a known point — the chaos test, bench rider, or a
    training loop's first step).  Without it the clock starts at the
    first attributed span."""
    if not ENABLED:
        return
    global _run_started
    with _lock:
        _run_started = time.monotonic()


def observe_span(name: str, dur_s: float) -> None:
    """Hot-path tap from ``flight.record()``: fold a completed span into
    the ledger when its name is a recognized unit of work.  One dict
    lookup for unrecognized names; compute spans recorded *during* a
    replay_scope are skipped (the scope already owns that wall-clock —
    counting both would book replayed steps as goodput)."""
    if not ENABLED:
        return
    cls = _SPAN_CLASS.get(name)
    if cls is None or dur_s <= 0.0:
        return
    if cls == "compute" and _replay_depth > 0:
        return
    now = time.monotonic()
    with _lock:
        if cls == "compute" and _device_deferred.get(name):
            _device_deferred[name] -= 1
            return
        _touch_clock_locked(now)
        b = _ledger.get(cls)
        if b is None:
            b = _ledger[cls] = {"seconds": 0.0, "events": 0}
        b["seconds"] += dur_s
        b["events"] += 1


def defer_span(name: str) -> bool:
    """The next ``name`` compute span is a replay that the card times:
    skip its host seconds.  False (nothing deferred) when the ledger is off
    or a replay scope owns the wall-clock."""
    if not ENABLED or _replay_depth > 0:
        return False
    with _lock:
        _device_deferred[name] = _device_deferred.get(name, 0) + 1
    return True


def observe_device(name: str, dur_s: float) -> None:
    """Book the card's time of one deferred ``name`` replay as compute."""
    if not ENABLED or dur_s <= 0.0:
        return
    now = time.monotonic()
    with _lock:
        _touch_clock_locked(now)
        b = _ledger.get("compute")
        if b is None:
            b = _ledger["compute"] = {"seconds": 0.0, "events": 0}
        b["seconds"] += dur_s
        b["events"] += 1


def attribute(reason: str, seconds: float) -> None:
    """Book ``seconds`` of wall-clock against taxonomy class ``reason``
    (discrete badput events: stall timeouts, shed requests, measured
    compile time).  Unknown reasons fold into ``unattributed`` with a
    one-shot warning — the taxonomy is closed by design."""
    if not ENABLED:
        return
    if reason not in CLASSES:
        if reason not in _warned_unknown:
            _warned_unknown.add(reason)
            log.warning("goodput.attribute: unknown class %r folded "
                        "into 'unattributed' (taxonomy: %s)",
                        reason, ", ".join(CLASSES))
        reason = "unattributed"
    if seconds < 0.0:
        seconds = 0.0
    now = time.monotonic()
    with _lock:
        _touch_clock_locked(now)
        b = _ledger.get(reason)
        if b is None:
            b = _ledger[reason] = {"seconds": 0.0, "events": 0}
        b["seconds"] += seconds
        b["events"] += 1
    if reason in _BADPUT_CLASSES and seconds > 0.0:
        try:
            from . import metrics as _metrics
            if _metrics.ENABLED:
                _metrics.BADPUT_SECONDS.inc(seconds, reason=reason)
        except Exception:  # noqa: BLE001 — accounting must not raise
            pass


def note_event(reason: str) -> None:
    """Count a taxonomy event whose duration is unknown.  Shows up in
    ``report()['events']`` without inventing seconds."""
    if not ENABLED:
        return
    with _lock:
        _events[reason] = _events.get(reason, 0) + 1


@contextlib.contextmanager
def replay_scope(reason: str):
    """Bracket a supervisor restore+replay (``retry_replay``) or
    divergence rewind (``rewind``): the scope's own wall-clock is
    attributed to ``reason``, and compute spans recorded while ANY scope
    is open are suppressed so replayed steps don't double-book as
    goodput.  Process-global on purpose — the supervisor can execute
    the replayed step_fn on a watchdog worker thread."""
    if not ENABLED:
        yield
        return
    global _replay_depth
    t0 = time.monotonic()
    with _lock:
        _replay_depth += 1
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        with _lock:
            _replay_depth -= 1
        attribute(reason, dt)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------
def report() -> dict:
    """The goodput account: ``{"classes": {cls: {"seconds", "events"}},
    "events": {...}, "wall_s", "attributed_s", "unattributed_s",
    "goodput_pct", "unattributed_pct"}``.  ``unattributed`` is derived
    — wall-clock since the run-clock origin minus everything the
    instruments claimed — so it is the honesty row: a big number here
    means a subsystem is running untraced."""
    if not ENABLED:
        return {"enabled": False}
    try:
        # replays the card finished since the last step: their time is
        # compute (lazy: the introspector times them)
        from . import introspect as _int
        _int.drain_device_times()
    except Exception:  # noqa: BLE001 — the account must not fail
        pass
    now = time.monotonic()
    with _lock:
        classes = {c: dict(b) for c, b in _ledger.items()}
        events = dict(_events)
        started = _run_started
    attributed = sum(b["seconds"] for b in classes.values())
    wall = max(0.0, now - started) if started is not None else 0.0
    # a fast instrumented burst can attribute more than the coarse wall
    # clock (span overlap); clamp instead of reporting negative slack
    wall = max(wall, attributed)
    unattributed = max(0.0, wall - attributed)
    compute = classes.get("compute", {}).get("seconds", 0.0)
    goodput_pct = (100.0 * compute / wall) if wall > 0 else 0.0
    unattr_pct = (100.0 * unattributed / wall) if wall > 0 else 0.0
    return {"enabled": True, "classes": classes, "events": events,
            "wall_s": wall, "attributed_s": attributed,
            "unattributed_s": unattributed,
            "goodput_pct": goodput_pct,
            "unattributed_pct": unattr_pct}


def ratio() -> float:
    """goodput fraction in [0, 1] (the ``mxnet_goodput_ratio`` gauge);
    0.0 before any attribution."""
    if not ENABLED:
        return 0.0
    r = report()
    return r["goodput_pct"] / 100.0 if r.get("enabled") else 0.0


def badput_totals() -> Dict[str, float]:
    """Cumulative seconds per badput class (timeline counter track)."""
    if not ENABLED:
        return {}
    with _lock:
        return {c: b["seconds"] for c, b in _ledger.items()
                if c != "compute"}


# ---------------------------------------------------------------------------
# SLO burn monitors
# ---------------------------------------------------------------------------
def serve_latency_sample(ms: float) -> None:
    """Feed one end-to-end serve latency into the sliding p99 window
    (called from the ResilientServer dispatch path) and evaluate the
    serve SLO."""
    if not ENABLED:
        return
    with _lock:
        _serve_lat_ms.append(ms)
    if SLO_SERVE_P99_MS > 0.0:
        maybe_fire_slo("serve_p99")


def _serve_p99_locked() -> Optional[float]:
    if len(_serve_lat_ms) < SLO_MIN_SAMPLES:
        return None
    xs = sorted(_serve_lat_ms)
    return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


def slo_state() -> dict:
    """Declared targets + current measurements + burn flags, for
    ``snapshot()["goodput"]["slo"]`` and the readyz detail row."""
    if not ENABLED:
        return {}
    with _lock:
        p99 = _serve_p99_locked()
        n = len(_serve_lat_ms)
        burning = dict(_slo_burning)
    out: dict = {}
    if SLO_GOODPUT_PCT > 0.0:
        out["goodput"] = {"target_pct": SLO_GOODPUT_PCT,
                          "actual_pct": report().get("goodput_pct"),
                          "burning": burning.get("goodput", False)}
    if SLO_SERVE_P99_MS > 0.0:
        out["serve_p99"] = {"target_ms": SLO_SERVE_P99_MS,
                            "actual_ms": p99, "samples": n,
                            "burning": burning.get("serve_p99", False)}
    return out


def _evaluate(slo: str) -> Optional[bool]:
    """Is ``slo`` currently violated?  None == not enough signal."""
    if slo == "serve_p99":
        with _lock:
            p99 = _serve_p99_locked()
        if p99 is None:
            return None
        return p99 > SLO_SERVE_P99_MS
    if slo == "goodput":
        r = report()
        if r.get("wall_s", 0.0) < SLO_MIN_RUN_S:
            return None
        return r["goodput_pct"] < SLO_GOODPUT_PCT
    return None


def maybe_fire_slo(slo: str) -> bool:
    """Evaluate one SLO; on breach set its burning flag and (rate-
    limited by ``SLO_BURN_MIN_S``) warn + ``mxnet_slo_burn_total{slo}``
    + journal a ``slo_burn`` entry.  Returns the burning state.  The
    flag clears as soon as an evaluation passes — readyz() reflects the
    live window, not history."""
    if not ENABLED:
        return False
    violated = _evaluate(slo)
    if violated is None:
        return _slo_burning.get(slo, False)
    with _lock:
        _slo_burning[slo] = violated
        if not violated:
            return False
        now = time.monotonic()
        last = _slo_last_fire.get(slo)
        if last is not None and now - last < SLO_BURN_MIN_S:
            return True
        _slo_last_fire[slo] = now
    detail = slo_state().get(slo, {})
    log.warning("SLO BURN (%s): %s", slo, detail)
    try:
        from . import metrics as _metrics
        if _metrics.ENABLED:
            _metrics.SLO_BURN.inc(slo=slo)
    except Exception:  # noqa: BLE001
        pass
    try:
        from . import journal as _journal
        if _journal.ENABLED:
            _journal.emit("slo_burn", durable=True, slo=slo, **detail)
    except Exception:  # noqa: BLE001
        pass
    return True


def slo_burning() -> bool:
    """Any SLO currently burning?  (the readyz() ``slo_burn`` check —
    re-evaluates the goodput SLO lazily since nothing else polls it)."""
    if not ENABLED:
        return False
    if SLO_GOODPUT_PCT > 0.0:
        maybe_fire_slo("goodput")
    return any(_slo_burning.values())


def slo_armed() -> bool:
    """Is any SLO target declared?  (readyz only lists the check when
    an operator opted in)."""
    if not ENABLED:
        return False
    return SLO_GOODPUT_PCT > 0.0 or SLO_SERVE_P99_MS > 0.0


# ---------------------------------------------------------------------------
# toggles + test plumbing
# ---------------------------------------------------------------------------
def enable() -> None:
    """Turn the ledger on at runtime (overrides MXNET_GOODPUT=0)."""
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def configure(slo_goodput_pct: Optional[float] = None,
              slo_serve_p99_ms: Optional[float] = None,
              slo_burn_min_s: Optional[float] = None,
              slo_min_samples: Optional[int] = None,
              slo_min_run_s: Optional[float] = None) -> None:
    """Override SLO targets/rate-limits at runtime (tests, notebooks)."""
    global SLO_GOODPUT_PCT, SLO_SERVE_P99_MS, SLO_BURN_MIN_S
    global SLO_MIN_SAMPLES, SLO_MIN_RUN_S
    if slo_goodput_pct is not None:
        SLO_GOODPUT_PCT = float(slo_goodput_pct)
    if slo_serve_p99_ms is not None:
        SLO_SERVE_P99_MS = float(slo_serve_p99_ms)
    if slo_burn_min_s is not None:
        SLO_BURN_MIN_S = float(slo_burn_min_s)
    if slo_min_samples is not None:
        SLO_MIN_SAMPLES = int(slo_min_samples)
    if slo_min_run_s is not None:
        SLO_MIN_RUN_S = float(slo_min_run_s)


def reset() -> None:
    """Zero the ledger, run clock, and SLO state (tests)."""
    global _run_started, _replay_depth
    with _lock:
        _ledger.clear()
        _events.clear()
        _run_started = None
        _replay_depth = 0
        _warned_unknown.clear()
        _device_deferred.clear()
        _serve_lat_ms.clear()
        _slo_last_fire.clear()
        _slo_burning.clear()
