"""Profiler (parity: ``mxnet_tpu/profiler.py`` over the reference's
``src/engine/profiler.cc``).

A façade over ``mxnet_tpu_torch.observability``: the span API
(``observability.tracing.trace_span``) and the metrics registry feed the
two timelines this module owns —

  - python side: a Chrome-trace event buffer (``_events``) of
    ``trace_span`` scopes, on the ``time.perf_counter`` clock;
  - device side: ``profiler_set_state('run')`` starts a
    ``torch.profiler.profile`` with CPU and (on a CUDA machine) CUDA
    activities, where the JAX package starts ``jax.profiler.start_trace``.
    Spans enter ``torch.profiler.record_function``, so the kernels a span
    launched sit under it in that trace.

``dump_profile()`` stops the session and writes ONE Chrome trace: the
profiler's own events (host ranges, CUDA runtime calls, kernels) shifted
onto the ``perf_counter`` clock through a marker range recorded at the
start, merged with the span events.  ``flight.dump()`` merges the same
events.  CUPTI sometimes records no device events in a session; the
trace then holds the host side only (``device_event_count()`` says so).

The MXNet API is unchanged: ``set_config``/``set_state``/
``dump_profile``/``pause``/``resume`` and ``MXNET_PROFILER_AUTOSTART``.
``pause()`` only suppresses the span events; a stop->run transition
clears the buffers.  ``dump_profile()`` writes atomically.
"""
from __future__ import annotations

import atexit
import json
import os
import tempfile
import time
from typing import List, Optional

from .base import atomic_write, getenv

_config = {"profile_all": False, "profile_symbolic": True,
           "profile_imperative": False, "profile_memory": False,
           "profile_api": False, "filename": "profile.json"}
_state = "stop"
_paused = False
_events: List[dict] = []
#: the last torch.profiler session's events, on the perf_counter clock
_device_events: List[dict] = []
_session = None
_sync_us: Optional[float] = None
_SYNC_NAME = "mxnet_profiler_clock_sync"


def profiler_set_config(mode="symbolic", filename="profile.json", **kwargs):
    """Parity: MXSetProfilerConfig."""
    _config["filename"] = filename
    _config["profile_all"] = mode == "all"
    _config.update(kwargs)


set_config = profiler_set_config


def profiler_set_state(state="stop"):
    """Parity: MXSetProfilerState — 'run' starts a torch.profiler session,
    'stop' ends it (its events are kept for ``dump_profile``).  Only the
    stop->run transition clears the buffers."""
    global _state, _paused
    if state == "run" and _state != "run":
        _events.clear()
        _device_events.clear()
        _paused = False
        _start_session()
    elif state == "run":
        _paused = False
    elif state == "stop" and _state == "run":
        _stop_session()
    _state = state


set_state = profiler_set_state


def _start_session() -> None:
    global _session, _sync_us
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        _session = torch.profiler.profile(activities=acts)
        _session.__enter__()
    except Exception:  # noqa: BLE001 — no session: host events only
        _session = None
        return
    # a marker whose profiler timestamp is matched to perf_counter's
    _sync_us = time.perf_counter() * 1e6
    with torch.profiler.record_function(_SYNC_NAME):
        pass


def _stop_session() -> None:
    """End the torch.profiler session and keep its events, moved onto the
    perf_counter clock."""
    global _session
    sess, _session = _session, None
    if sess is None:
        return
    try:
        sess.__exit__(None, None, None)
        fd, tmp = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            sess.export_chrome_trace(tmp)
            with open(tmp) as f:
                trace = json.load(f)
        finally:
            os.unlink(tmp)
    except Exception:  # noqa: BLE001 — a failed export keeps host events
        return
    evs = [e for e in trace.get("traceEvents", [])
           if isinstance(e, dict)]
    offset = 0.0
    for e in evs:
        if e.get("name") == _SYNC_NAME and "ts" in e:
            offset = float(e["ts"]) - _sync_us
            break
    _device_events[:] = []
    for e in evs:
        if e.get("name") == _SYNC_NAME:
            continue
        if "ts" in e:
            e = dict(e)
            e["ts"] = float(e["ts"]) - offset
        _device_events.append(e)


def record_event(name: str, start_us: float, end_us: float, cat="operator",
                 tid: int = 0, args: Optional[dict] = None):
    """Timeline hook: ``trace_span`` scopes land here as Chrome-trace
    complete events (suppressed while paused)."""
    if _state == "run" and not _paused:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": start_us, "dur": end_us - start_us,
              "pid": 0, "tid": tid}
        if args:
            ev["args"] = args
        _events.append(ev)


def is_running() -> bool:
    """Parity: profiler state is 'run' (paused still counts as running)."""
    return _state == "run"


def is_recording() -> bool:
    """True when events should be recorded: running AND not paused — the
    predicate every hot-path hook tests first."""
    return _state == "run" and not _paused


def events_for_dump() -> List[dict]:
    """The span events and the last exported session's events, one clock."""
    return list(_events) + list(_device_events)


def device_event_count() -> int:
    """Kernel and memcpy events the last exported session holds (0 when
    CUPTI recorded no device activity)."""
    return sum(1 for e in _device_events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


def dump_profile():
    """Parity: MXDumpProfile — stop the session and write one Chrome trace
    of the span events merged with the profiler's host and device events,
    atomically (``base.atomic_write``)."""
    global _state
    if _state == "run":
        _stop_session()
    _state = "stop"
    atomic_write(_config["filename"],
                 json.dumps({"traceEvents": events_for_dump(),
                             "displayTimeUnit": "ms"}))


def pause():
    """Parity: MXProfilePause — suppress the span events, keep everything
    already recorded (the profiler stays formally 'running')."""
    global _paused
    _paused = True


def resume():
    """Parity: MXProfileResume."""
    global _paused
    _paused = False


# -- observability façade -----------------------------------------------------
def trace_span(name: str, cat: str = "runtime"):
    from .observability.tracing import trace_span as _ts
    return _ts(name, cat=cat)


def step_span(step_num: int, name: str = "train"):
    from .observability.tracing import step_span as _ss
    return _ss(step_num, name=name)


def dump_metrics() -> dict:
    """Snapshot of the runtime metrics registry (observability.metrics)."""
    from .observability import metrics as _m
    return _m.snapshot()


def phase_span(name: str, cat: str = "phase", **kw):
    """Flight-recorder phase span (observability.flight) — always-on ring
    recording, independent of the profiler state."""
    from .observability.flight import phase_span as _ps
    return _ps(name, cat=cat, **kw)


def dump_flight(path=None):
    """Dump the flight-recorder ring (merged with this profiler's events)
    as Perfetto-loadable Chrome trace JSON."""
    from .observability.flight import dump as _dump
    return _dump(path)


if getenv("MXNET_PROFILER_AUTOSTART", 0):
    profiler_set_config(mode="all", filename="profile_output.json")
    profiler_set_state("run")
    atexit.register(dump_profile)
