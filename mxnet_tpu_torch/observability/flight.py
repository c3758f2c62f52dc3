"""Flight recorder: always-on, low-overhead phase timelines (parity:
``mxnet_tpu/observability/flight.py``).

The metrics registry answers "how many / how much"; the profiler answers
"everything, while someone watches".  Neither answers "why was step 4182
(or request 9f3-77) slow, twenty minutes ago?".  This module is the
black-box recorder in between:

  * **ring buffers of phase records** — ``phase_span("allreduce", ...)``
    appends ``(name, cat, t0, t1, step, trace_id, labels)`` to a
    fixed-size per-thread ring (``MXNET_FLIGHT_RING`` records/thread).
    Writes are lock-free after the first record on a thread: each
    thread owns its segment (the one lock guards segment
    *registration*, once per thread).  Old records are overwritten
    (counted as ``drops``): memory is bounded forever.
  * **trace ids** — a per-request id minted at submit and carried
    through queue-wait, pad, dispatch and slice via ``trace_scope``
    (thread-local), so one request's spans are joinable across the
    batcher/scheduler threads in a dump.
  * **anomaly watchdog** — phases recorded with ``watch=True`` feed a
    per-phase EWMA; a sample exceeding ``MXNET_FLIGHT_SLOW_FACTOR`` x
    the EWMA triggers an automatic ring dump to ``MXNET_FLIGHT_DIR``
    (rate-limited), capturing the moments *before* the anomaly.
    ``SIGUSR2`` dumps on demand.
  * **exporters** — ``dump()`` writes Chrome trace-event JSON
    (Perfetto-loadable; merges the profiler's host events, and, when a
    ``torch.profiler`` session was exported by ``profiler.dump_profile``,
    its device events), ``summary()`` returns per-phase p50/p99/total +
    slowest-N records (``observability.snapshot()["flight"]``).

A captured CUDA graph runs no Python at replay time, so every span sits
outside the graph: a ``whole_step`` span times the host's replay call
(the kernels it enqueued run after it returns unless something waits).

Overhead contract: ``MXNET_FLIGHT=0`` reduces every hook to ONE
module-global boolean test.  Enabled, a span costs two ``perf_counter``
reads and one list-slot store.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..base import getenv, unique_path, atomic_write
from ..analysis import sanitizer as _san
from . import goodput as _goodput
from . import journal as _journal

log = logging.getLogger(__name__)

__all__ = ["ENABLED", "enable", "disable", "enabled", "phase_span",
           "watch_ewma",
           "record", "note", "now_us", "new_trace_id", "trace_scope",
           "current_trace_id", "join_ids", "records", "stats", "dump",
           "summary", "snapshot_summary", "reset", "configure"]

# -- the fast-path switch ----------------------------------------------------
# Hooks across trainer/module/serving/checkpoint/io read this module
# global directly:  `if flight.ENABLED: ...` / phase_span's first test.
ENABLED: bool = getenv("MXNET_FLIGHT", True)
#: per-thread ring capacity, in records
RING: int = int(getenv("MXNET_FLIGHT_RING", 4096))
#: watchdog trigger: sample > SLOW_FACTOR x EWMA (after warmup) dumps
SLOW_FACTOR: float = float(getenv("MXNET_FLIGHT_SLOW_FACTOR", 4.0))
#: minimum seconds between automatic anomaly dumps (tests set 0)
AUTO_DUMP_MIN_S: float = 30.0

_ALPHA = 0.3       # EWMA smoothing for the watchdog
_WARMUP = 5        # samples before a phase's EWMA can trigger


def enabled() -> bool:
    return ENABLED


def enable() -> None:
    global ENABLED
    ENABLED = True
    # a process started with MXNET_FLIGHT=0 skipped the import-time
    # install; the documented kill -USR2 contract must start holding
    # the moment the recorder is enabled (no-op off the main thread —
    # a later main-thread enable() picks it up)
    _install_signal_handler()


def disable() -> None:
    global ENABLED
    ENABLED = False


# -- ring storage ------------------------------------------------------------
# Record tuple layout (indices are load-bearing for timeline.py):
#   (name, cat, t0_us, t1_us, step, trace_id, labels)
class _Segment:
    """One thread's ring.  Only its owner thread writes; readers
    (dump/summary) snapshot ``buf``/``n`` without a lock — a slot being
    overwritten concurrently yields either the old or the new record,
    never a torn one (list-slot stores are GIL-atomic)."""

    __slots__ = ("tid", "thread_name", "cap", "buf", "n", "epoch",
                 "_thread_ref")

    def __init__(self, tid: int, thread_name: str, cap: int, epoch: int):
        self.tid = tid
        self.thread_name = thread_name
        self.cap = cap
        self.buf: List[Optional[tuple]] = [None] * cap
        self.n = 0          # total records ever written
        self.epoch = epoch
        import weakref
        self._thread_ref = weakref.ref(threading.current_thread())

    @property
    def thread_alive(self) -> bool:
        t = self._thread_ref()
        return t is not None and t.is_alive()

    def add(self, rec: tuple) -> None:
        self.buf[self.n % self.cap] = rec
        self.n += 1

    @property
    def drops(self) -> int:
        return max(0, self.n - self.cap)


_tls = threading.local()
_segments: List[_Segment] = []
_epoch = 0
# registration lock only (once per thread per epoch); rebuilt by
# configure() so sanitizer drills that enable() after import still get
# tracked locks.  REENTRANT on purpose: a signal handler (SIGTERM
# emergency checkpoint) runs flight-instrumented code inline on the
# interrupted thread — if that thread was inside reset()/stats()/
# segment registration holding this lock, a non-reentrant lock would
# self-deadlock the handler (same reason the SIGUSR2 dump runs on a
# background thread)
_seg_lock = _san.make_rlock("flight.segments")
_watch_lock = _san.make_lock("flight.watch")
_watch: Dict[str, Tuple[float, int]] = {}   # name -> (ewma_s, count)
# None = no auto-dump yet (the sentinel matters: time.monotonic() can be
# SMALLER than AUTO_DUMP_MIN_S on a freshly booted machine, and a 0.0
# seed would then swallow the first anomaly dump)
_last_auto_dump: Optional[float] = None
_last_anomaly: dict = {}
_dump_count = 0
_last_dump_path: Optional[str] = None
_trace_counter = itertools.count(1)
_PID_TAG = "%x" % os.getpid()


#: dead-thread segments kept for post-mortem (a worker that died is
#: exactly what a dump should still show); older ones are pruned at
#: registration so thread churn (one prefetcher per epoch, pool
#: restarts) cannot grow _segments — and recorder memory — forever
MAX_DEAD_SEGMENTS = 16


def _segment() -> _Segment:
    seg = getattr(_tls, "seg", None)
    if seg is None or seg.epoch != _epoch:
        from .tracing import _tid
        t = threading.current_thread()
        seg = _Segment(_tid(), t.name, RING, _epoch)
        with _seg_lock:
            dead = [s for s in _segments if not s.thread_alive]
            if len(dead) > MAX_DEAD_SEGMENTS:
                # registration order = age: drop the oldest dead ones
                for s in dead[:len(dead) - MAX_DEAD_SEGMENTS]:
                    _segments.remove(s)
            _segments.append(seg)
        _tls.seg = seg
    return seg


def _now_us() -> float:
    return time.perf_counter() * 1e6


def now_us() -> float:
    """The recorder's clock (perf_counter microseconds) — for call
    sites that span non-lexical scopes and call ``record`` directly."""
    return _now_us()


# -- trace ids ---------------------------------------------------------------
def new_trace_id() -> str:
    """Mint a process-unique request id (lock-free)."""
    return f"{_PID_TAG}-{next(_trace_counter)}"


def current_trace_id() -> Optional[str]:
    return getattr(_tls, "trace", None)


@contextlib.contextmanager
def trace_scope(trace_id: Optional[str]):
    """Bind ``trace_id`` to this thread for the scope: records that
    don't pass an explicit id inherit it — how a request's id crosses
    the pad/dispatch/slice phases on the dispatcher thread."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace_id
    try:
        yield
    finally:
        _tls.trace = prev


def join_ids(ids) -> Optional[str]:
    """One scope id for a coalesced group: the single id, or a comma
    join — each member id stays greppable/joinable in the dump."""
    ids = [i for i in ids if i]
    if not ids:
        return None
    return ids[0] if len(ids) == 1 else ",".join(ids)


# -- recording ---------------------------------------------------------------
def record(name: str, cat: str, t0_us: float, t1_us: float,
           step: Optional[int] = None, trace_id: Optional[str] = None,
           labels: Optional[dict] = None, watch: bool = False) -> None:
    """Append one finished phase to this thread's ring.  Timestamps are
    microseconds on the ``time.perf_counter`` clock — the SAME clock
    ``tracing``/``profiler`` events use, so a merged dump orders
    correctly across all three sources."""
    if not ENABLED:
        return
    if trace_id is None:
        trace_id = getattr(_tls, "trace", None)
    _segment().add((name, cat, t0_us, t1_us, step, trace_id, labels))
    if _goodput.ENABLED:
        # one boolean + one dict lookup: top-level unit-of-work spans
        # feed the run's goodput ledger (docs/goodput.md)
        _goodput.observe_span(name, (t1_us - t0_us) / 1e6)
    if watch:
        note(name, (t1_us - t0_us) / 1e6)


def _mem_live():
    """Tracked device bytes from the memory ledger, or None when the
    ledger is off (lazy import: memory ↔ flight is a benign cycle
    broken by function-level imports on both sides)."""
    from . import memory as _mem
    return _mem.tracked_bytes() if _mem.ENABLED else None


@contextlib.contextmanager
def phase_span(name: str, cat: str = "phase", step: Optional[int] = None,
               trace_id: Optional[str] = None,
               labels: Optional[dict] = None, watch: bool = False,
               mem: bool = False):
    """The flight-recorder primitive: time the body and ring-record it.

    ``MXNET_FLIGHT=0``: ONE boolean test, nothing else.  ``watch=True``
    additionally feeds the slow-phase watchdog (k×EWMA anomaly dump).
    ``mem=True`` samples the memory ledger's tracked device bytes at entry
    and exit (two O(1) counter reads; skipped when
    ``MXNET_MEMORY_LEDGER=0``) and labels the record with
    ``mem_delta_bytes``/``mem_live_bytes`` — the per-phase memory
    timeline: ``dump()`` renders these as a Perfetto counter track, so
    the timeline shows WHICH phase grew device memory.  The sampled counter is
    PROCESS-global: a concurrent thread allocating inside this span's
    window (e.g. the prefetcher staging the next batch during a
    trainer step) lands in this span's delta too — read overlapping
    spans' deltas together, per-tag truth lives in ``memory.report()``.
    Phase ``name``s must come from a bounded literal set (every distinct
    name is a forever-entry in ``summary()``).
    """
    if not ENABLED:
        yield
        return
    t0 = _now_us()
    m0 = _mem_live() if mem else None
    try:
        yield
    finally:
        if m0 is not None:
            m1 = _mem_live()
            if m1 is not None:
                labels = dict(labels) if labels else {}
                labels["mem_delta_bytes"] = int(m1 - m0)
                labels["mem_live_bytes"] = int(m1)
        record(name, cat, t0, _now_us(), step=step, trace_id=trace_id,
               labels=labels, watch=watch)


# -- watchdog ----------------------------------------------------------------
def note(name: str, dur_s: float) -> None:
    """Feed one duration sample into ``name``'s EWMA; trigger an
    anomaly dump when it exceeds ``SLOW_FACTOR`` × the warmed EWMA.
    The slow sample still folds into the EWMA afterwards, so a
    *sustained* regime change dumps once and re-adapts instead of
    dumping forever."""
    if not ENABLED:
        return
    anomaly = False
    ewma = 0.0
    with _watch_lock:
        e, c = _watch.get(name, (0.0, 0))
        if c >= _WARMUP and e > 0.0 and dur_s > SLOW_FACTOR * e:
            anomaly, ewma = True, e
        _watch[name] = (dur_s if c == 0 else
                        _ALPHA * dur_s + (1.0 - _ALPHA) * e, c + 1)
    if anomaly:
        _anomaly_dump(name, dur_s, ewma)


def watch_state() -> Dict[str, dict]:
    with _watch_lock:
        return {k: {"ewma_ms": round(e * 1e3, 3), "count": c}
                for k, (e, c) in sorted(_watch.items())}


def watch_ewma(name: str) -> Optional[float]:
    """The warmed EWMA (seconds) of a ``watch=True`` phase, or None
    before ``_WARMUP`` samples.  The training stall watchdog
    (gluon/supervisor.py) seeds its step deadline from the
    ``trainer_step``/``whole_step`` phases through this."""
    with _watch_lock:
        e, c = _watch.get(name, (0.0, 0))
    return e if c >= _WARMUP and e > 0.0 else None


def _anomaly_dump(phase: str, dur_s: float, ewma_s: float) -> None:
    global _last_auto_dump
    now = time.monotonic()
    with _watch_lock:
        if _last_auto_dump is not None and \
                now - _last_auto_dump < AUTO_DUMP_MIN_S:
            return
        _last_auto_dump = now
    _last_anomaly.clear()
    _last_anomaly.update({"phase": phase,
                          "duration_ms": round(dur_s * 1e3, 3),
                          "ewma_ms": round(ewma_s * 1e3, 3),
                          "factor": SLOW_FACTOR})
    # the dump itself (JSON of up to ring-size records) runs OFF the
    # hot path that detected the anomaly — the ring keeps the moments
    # before it regardless of when the writer thread gets scheduled
    threading.Thread(target=_bg_dump, args=("anomaly",),
                     name="mxt-flight-dump", daemon=True).start()


def _bg_dump(reason: str) -> None:
    try:
        path = dump(reason=reason)
        if reason == "anomaly":
            _last_anomaly["path"] = path
        log.warning("flight recorder %s dump: %s (%s)", reason, path,
                    _last_anomaly if reason == "anomaly" else "")
    except Exception as e:  # noqa: BLE001 — a failed dump must not kill
        log.warning("flight recorder %s dump failed: %s", reason, e)


# -- export ------------------------------------------------------------------
def records() -> List[tuple]:
    """Snapshot every live record as ``(segment, record)`` pairs sorted
    by t0 — the raw feed ``timeline``/``summary`` build from."""
    out = []
    with _seg_lock:
        segs = list(_segments)
    for seg in segs:
        n = seg.n
        for r in list(seg.buf[:min(n, seg.cap)] if n <= seg.cap
                      else seg.buf):
            if r is not None:
                out.append((seg, r))
    out.sort(key=lambda p: p[1][2])
    return out


def stats() -> dict:
    with _seg_lock:
        segs = list(_segments)
    written = sum(s.n for s in segs)
    drops = sum(s.drops for s in segs)
    return {"enabled": ENABLED, "ring": RING,
            "records": written - drops, "written": written,
            "drops": drops, "segments": len(segs),
            "dumps": _dump_count, "last_dump": _last_dump_path,
            "last_anomaly": dict(_last_anomaly)}


def dump(path: Optional[str] = None, reason: str = "manual",
         clock=None) -> str:
    """Write the ring (+ the profiler's ``_events``) as Chrome
    trace-event JSON, atomically — open the file in Perfetto / chrome
    about:tracing.  ``path=None`` writes a collision-free timestamped
    file under ``MXNET_FLIGHT_DIR`` (default ``.``); ``clock`` is the
    injectable timestamp source for the filename (tests pin it)."""
    global _dump_count, _last_dump_path
    from . import timeline as _timeline
    from .. import profiler as _prof
    meta = {"reason": reason,
            **({"anomaly": dict(_last_anomaly)} if _last_anomaly else {})}
    if _journal.ENABLED:
        # cross-reference: the dump names its run, the journal names
        # the dump — an operator pivots either way (docs/goodput.md)
        meta["run_id"] = _journal.run_id()
        meta["journal_path"] = _journal.path()
    trace = _timeline.build_trace(records(), _prof.events_for_dump(),
                                  meta=meta)
    if path is None:
        d = os.environ.get("MXNET_FLIGHT_DIR", ".") or "."
        os.makedirs(d, exist_ok=True)
        path = unique_path(d, "flight", ".json", clock=clock)
    atomic_write(path, json.dumps(trace))
    _dump_count += 1
    _last_dump_path = path
    from . import metrics as _metrics
    if _metrics.ENABLED:
        # reason is one of {"manual", "anomaly", "signal", "oom",
        # "divergence", "stall", "preempt"} — bounded
        _metrics.FLIGHT_DUMPS.inc(reason=reason)
    if _journal.ENABLED:
        _journal.note_dump(path, reason)
    return path


def summary(top: int = 3) -> dict:
    """Per-phase latency digest of the current ring: count, total,
    p50/p99/max, and the slowest ``top`` records (with step/trace_id —
    the exemplar hop from a bad percentile to a concrete timeline)."""
    from . import timeline as _timeline
    return _timeline.summarize(records(), top=top)


def snapshot_summary() -> dict:
    """The compact block ``observability.snapshot()["flight"]`` carries."""
    out = stats()
    out["phases"] = summary(top=3)
    out["watch"] = watch_state()
    return out


# -- lifecycle ---------------------------------------------------------------
def reset() -> None:
    """Drop every segment/record and the watchdog state (tests).  Other
    threads' next record lands in a fresh segment (epoch bump)."""
    global _epoch, _last_auto_dump
    with _seg_lock:
        _epoch += 1
        _segments.clear()
    with _watch_lock:
        _watch.clear()
    _last_auto_dump = None
    _last_anomaly.clear()


def configure(ring: Optional[int] = None,
              slow_factor: Optional[float] = None) -> None:
    """Re-size the per-thread ring / watchdog factor and reset.  Also
    rebuilds the module locks through the sanitizer factories, so a
    drill that calls ``sanitizer.enable()`` after import gets tracked
    locks (the import-time ones predate it)."""
    global RING, SLOW_FACTOR, _seg_lock, _watch_lock
    if ring is not None:
        RING = max(1, int(ring))
    if slow_factor is not None:
        SLOW_FACTOR = float(slow_factor)
    _seg_lock = _san.make_rlock("flight.segments")
    _watch_lock = _san.make_lock("flight.watch")
    reset()


# -- SIGUSR2: dump on demand --------------------------------------------------
_signal_installed = False


def _install_signal_handler() -> None:
    """kill -USR2 <pid> → flight dump (production escape hatch: grab a
    timeline from a live process without attaching anything).  Chains a
    pre-existing handler; installs at most once (re-invoked by
    ``enable()`` for MXNET_FLIGHT=0 starts); silently unavailable off
    the main thread or on platforms without SIGUSR2."""
    global _signal_installed
    if not ENABLED or _signal_installed:
        return
    try:
        import signal
        if threading.current_thread() is not threading.main_thread():
            return
        prev = signal.getsignal(signal.SIGUSR2)

        def _on_usr2(signum, frame):
            # the dump runs on a BACKGROUND thread, never inline: the
            # handler executes between bytecodes of the interrupted
            # main thread, which may already hold _seg_lock or the
            # metrics mutation lock — an inline dump() would then
            # self-deadlock the whole process on a non-reentrant lock
            try:
                threading.Thread(target=_bg_dump, args=("signal",),
                                 name="mxt-flight-dump",
                                 daemon=True).start()
            except Exception:  # noqa: BLE001 — never die in a handler
                pass
            if callable(prev):
                prev(signum, frame)

        signal.signal(signal.SIGUSR2, _on_usr2)
        _signal_installed = True
    except (ValueError, OSError, AttributeError):
        pass


_install_signal_handler()
