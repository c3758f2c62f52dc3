"""Structured tracing spans that land in BOTH timelines (parity:
``mxnet_tpu/observability/tracing.py``).

`with trace_span("forward"):` emits
  - a python-side Chrome-trace complete event ("X") into the profiler's
    `_events` buffer (dumped by `profiler.dump_profile()`), and
  - a `torch.profiler.record_function` range and, on a CUDA machine, a
    `torch.cuda.nvtx` range, so the same span shows up in the
    `torch.profiler` trace next to the kernels it launched (the JAX
    package enters `jax.profiler.TraceAnnotation` here).

`step_span(step)` does the same for a step boundary and, always, feeds
the flight recorder (`observability.flight`) even while the profiler is
paused or stopped: both timelines stamp the SAME `time.perf_counter()`
clock, so flight records and profiler `_events` agree on ordering.

Fast path: when the profiler is stopped, a `trace_span` is ONE predicate
test — no timestamps, no annotation objects.  A captured CUDA graph runs
no Python when it replays, so a span around a replay times the host's
launch, and the kernels show inside it through the profiler's
launch-to-kernel correlation.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time

from ..analysis.sanitizer import make_lock as _make_lock

_tls = threading.local()
_tid_lock = _make_lock("tracing.tid")
_tid_map: dict = {}
_nvtx = None   # torch.cuda.nvtx when a CUDA device is present, else False


def _tid() -> int:
    """Small stable per-thread id (Chrome trace tids are more readable
    than 140-bit thread idents).  Shared with the flight recorder so
    merged dumps line threads up."""
    t = getattr(_tls, "tid", None)
    if t is None:
        with _tid_lock:
            t = _tid_map.setdefault(threading.get_ident(), len(_tid_map))
        _tls.tid = t
    return t


def _depth() -> int:
    return getattr(_tls, "depth", 0)


def _profiler():
    from .. import profiler
    return profiler


def _flight():
    from . import flight
    return flight


class _Annotation:
    """A ``record_function`` range plus an NVTX range (CUDA only)."""

    __slots__ = ("name", "_rf", "_pushed")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._pushed = False

    def __enter__(self):
        global _nvtx
        import torch
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if _nvtx is None:
            _nvtx = torch.cuda.nvtx if torch.cuda.is_available() else False
        if _nvtx:
            _nvtx.range_push(self.name)
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            self._pushed = False
            _nvtx.range_pop()
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False


def _annotation(name: str):
    try:
        return _Annotation(name)
    except Exception:  # noqa: BLE001 — tracing must never break a step
        return None


@contextlib.contextmanager
def trace_span(name: str, cat: str = "runtime"):
    """Record `name` as a nested span on both timelines while the
    profiler runs; a no-op predicate test otherwise.

    Exception-safe depth accounting: the increment/decrement pair and
    the event record sit in `finally` blocks, so a raising body can
    neither leak a depth level nor lose the event."""
    prof = _profiler()
    if not prof.is_recording():
        yield
        return
    ann = _annotation(name)
    start = time.perf_counter() * 1e6
    _tls.depth = _depth() + 1
    entered = False
    try:
        if ann is not None:
            ann.__enter__()
            entered = True
        try:
            yield
        except BaseException:
            # the annotation sees exactly the exception unwinding
            # through the span body
            if entered:
                entered = False
                ann.__exit__(*sys.exc_info())
            raise
        if entered:
            entered = False
            ann.__exit__(None, None, None)
    finally:
        end = time.perf_counter() * 1e6
        _tls.depth = _depth() - 1
        prof.record_event(name, start, end, cat=cat, tid=_tid(),
                          args={"depth": _depth()})


@contextlib.contextmanager
def step_span(step_num: int, name: str = "train"):
    """Step-boundary annotation: a profiler range and Chrome-trace span
    while the profiler records, and an always-on flight-recorder step
    record (which also feeds the slow-step watchdog, `flight.note`)."""
    prof = _profiler()
    rec = prof.is_recording()
    fl = _flight()
    if not rec and not fl.ENABLED:
        yield
        return
    # bounded by construction: callers pass literal step-stream names
    # ("train"), so the derived record name is one entry per stream
    rec_name = name + "_step"
    ann = None
    if rec:
        ann = _annotation(rec_name)
        if ann is not None:
            try:
                ann.__enter__()
            except Exception:  # noqa: BLE001
                ann = None
    start = time.perf_counter() * 1e6
    try:
        try:
            yield
        except BaseException:
            if ann is not None:
                a, ann = ann, None
                a.__exit__(*sys.exc_info())
            raise
        if ann is not None:
            a, ann = ann, None
            a.__exit__(None, None, None)
    finally:
        end = time.perf_counter() * 1e6
        if rec:
            prof.record_event(rec_name, start, end, cat="step",
                              tid=_tid(), args={"step": step_num})
        if fl.ENABLED:
            fl.record(rec_name, "step", start, end, step=step_num,
                      watch=True)


def annotate(name: str):
    """Bare profiler range (no python-side event) — for spans that only
    matter relative to device kernels."""
    ann = _annotation(name)
    return ann if ann is not None else contextlib.nullcontext()
