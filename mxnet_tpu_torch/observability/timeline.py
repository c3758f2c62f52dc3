"""Timeline export for the flight recorder: Chrome trace-event JSON
(Perfetto-loadable) + per-phase latency digests (parity:
``mxnet_tpu/observability/timeline.py``).

One format, merged on one timeline:

  * flight-recorder ring records (``flight.records()``) — training and
    serving phase spans, per-thread tids, step/trace_id args;
  * the profiler's python-side events (``trace_span`` scopes) — already
    Chrome-trace complete events;
  * the device events of the last ``torch.profiler`` session that
    ``profiler.dump_profile`` exported, shifted onto the same clock.

All python-side producers stamp ``time.perf_counter()`` microseconds,
so sorting by ``ts`` is globally consistent.  Counter tracks: cumulative
badput per class, live ledger bytes per phase, and ``mxnet_flops_per_s``
for the step phases with a counted program: the program's flops over the
card's time for the phase where its replays are timed by CUDA events
(a replay's span times the host's enqueue, not the step), else over the
span.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["build_trace", "chrome_events", "summarize"]

#: pid stamped on every python-side event — matches profiler._events so
#: all sources group under one process row in the viewer
PID = 0


def _phase_flops() -> Dict[str, Tuple[float, Optional[float]]]:
    """{step phase: (counted flops per span, the card's seconds per span or
    None)} from the program introspector (lazy/guarded)."""
    try:
        from . import introspect as _int
        if not _int.ENABLED:
            return {}
        return {ph: (f, _int.device_step_time(ph))
                for ph, f in _int.phase_flops_map().items()}
    except Exception:  # noqa: BLE001
        return {}


def _badput_map() -> Dict[str, str]:
    """{span name: badput class} from the goodput ledger's taxonomy —
    the feed for the ``mxnet_badput_seconds`` counter track.
    Lazy/guarded: the exporter must never fail because of it."""
    try:
        from . import goodput as _gp
        if not _gp.ENABLED:
            return {}
        return {n: c for n, c in _gp._SPAN_CLASS.items()
                if c != "compute"}
    except Exception:  # noqa: BLE001
        return {}


def chrome_events(flight_records: List[tuple]) -> List[dict]:
    """``(segment, record)`` pairs → Chrome trace complete events plus
    one thread_name metadata event per segment."""
    events: List[dict] = []
    seen_tids: Dict[int, str] = {}
    badput_map = _badput_map()
    phase_flops = _phase_flops()
    badput_cum: Dict[str, float] = {}
    # cumulative badput must grow monotonically along the timeline, so
    # the counter walks records in span-end order regardless of which
    # thread segment recorded them
    for _, rec in sorted(flight_records, key=lambda p: p[1][3]):
        name, _, t0, t1, _, _, _ = rec
        cls = badput_map.get(name)
        if cls is None or t1 <= t0:
            continue
        badput_cum[cls] = badput_cum.get(cls, 0.0) + (t1 - t0) / 1e6
        # one "mxnet_badput_seconds" track per class: Perfetto renders
        # stacked cumulative badput lined up with the spans that caused
        # it
        events.append({"name": "mxnet_badput_seconds", "ph": "C",
                       "ts": t1, "pid": PID,
                       "args": {cls: round(badput_cum[cls], 6)}})
    for seg, rec in flight_records:
        name, cat, t0, t1, step, trace_id, labels = rec
        seen_tids.setdefault(seg.tid, seg.thread_name)
        ev = {"name": name, "cat": cat, "ph": "X", "ts": t0,
              "dur": t1 - t0, "pid": PID, "tid": seg.tid}
        args = {}
        if step is not None:
            args["step"] = step
        if trace_id is not None:
            args["trace_id"] = trace_id
        if labels:
            args.update(labels)
        if args:
            ev["args"] = args
        events.append(ev)
        if labels and "mem_live_bytes" in labels:
            # ledger-sampled phases also emit a Chrome COUNTER event at
            # phase end: Perfetto renders one "hbm_live_bytes" track
            # whose steps line up with the phase spans — the
            # which-phase-grew-memory view
            events.append({"name": "hbm_live_bytes", "ph": "C",
                           "ts": t1, "pid": PID,
                           "args": {"bytes": labels["mem_live_bytes"]}})
        if name in phase_flops and t1 > t0:
            flops, dev_s = phase_flops[name]
            secs = dev_s if dev_s else (t1 - t0) / 1e6
            events.append({"name": "mxnet_flops_per_s", "ph": "C",
                           "ts": t1, "pid": PID,
                           "args": {"flops_per_s": flops / secs}})
    for tid, tname in sorted(seen_tids.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": PID,
                       "tid": tid, "args": {"name": tname}})
    return events


def build_trace(flight_records: List[tuple],
                profiler_events: Optional[List[dict]] = None,
                meta: Optional[dict] = None) -> dict:
    """The full dump payload: flight events merged with the profiler's
    ``_events`` (same pid/clock), sorted by timestamp so viewers and
    tests see one coherent timeline."""
    events = chrome_events(flight_records)
    if profiler_events:
        events.extend(profiler_events)
    events.sort(key=lambda e: e.get("ts", 0))
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        out["metadata"] = dict(meta)
    return out


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def summarize(flight_records: List[tuple], top: int = 3) -> dict:
    """Per-phase digest: ``{name: {count, total_ms, p50_ms, p99_ms,
    max_ms, slowest: [{dur_ms, t0_us, step, trace_id}]}}`` — the
    compact complement of the full dump (``snapshot()["flight"]``).
    ``slowest`` carries step/trace_id so a bad percentile links to a
    concrete recorded timeline."""
    by_name: Dict[str, List[tuple]] = {}
    for _, rec in flight_records:
        by_name.setdefault(rec[0], []).append(rec)
    out: Dict[str, dict] = {}
    for name, recs in sorted(by_name.items()):
        durs = sorted(r[3] - r[2] for r in recs)   # microseconds
        slowest = sorted(recs, key=lambda r: r[3] - r[2],
                         reverse=True)[:max(0, top)]
        out[name] = {
            "count": len(durs),
            "total_ms": round(sum(durs) / 1e3, 3),
            "p50_ms": round(_pctl(durs, 0.50) / 1e3, 3),
            "p99_ms": round(_pctl(durs, 0.99) / 1e3, 3),
            "max_ms": round(durs[-1] / 1e3, 3),
            "slowest": [{"dur_ms": round((r[3] - r[2]) / 1e3, 3),
                         "t0_us": round(r[2], 1),
                         "step": r[4], "trace_id": r[5]}
                        for r in slowest],
        }
    return out
