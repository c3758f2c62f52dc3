"""The measured-sweep tuner: short paired-interleave probes pick the knobs
(parity: ``mxnet_tpu/autotune/sweep.py``).

The benches' statistic as a library: alternate the two legs pair by pair,
take the median of the adjacent-pair deltas over third-sized chunks and
keep the best chunk, so a burst of load from a neighbour on a shared host
poisons one chunk, not the verdict.

``tune()`` sweeps the superstep's K on the live compiler (staging K batches
asks ``memory.ensure_headroom`` first; a demoted candidate is recorded, not
scored), times the gradient bucketer's flatten and unflatten on the card
for each ``MXNET_BUCKET_SIZE_MB`` candidate, derives a serving bucket
lattice from observed batch sizes and a ``MicroBatcher`` hold window from
the flight recorder's serving dispatch EWMA, and persists the result
through ``autotune/decisions.py``: paid once per (model signature, card),
reloaded with zero sweep runs afterwards (``last_sweep_runs == 0``).
Every knob stays overridable by its environment variable
(``decisions.KNOB_ENV``).  Each timed leg waits for the card
(``torch.cuda.synchronize``) before its clock stops.
"""
from __future__ import annotations

import logging
import os
import time
from statistics import median
from typing import Dict, List, Optional, Sequence

import torch

from ..base import MXNetError, getenv
from . import decisions as _decisions

logger = logging.getLogger("mxnet_tpu_torch.autotune.sweep")

__all__ = ["chunked_delta_pct", "paired_interleave", "sweep_superstep_k",
           "sweep_bucket_size", "lattice_from_traffic",
           "max_wait_from_ewma", "tune", "last_sweep_runs"]

#: measured probe runs of the LAST tune() call: 0 on a decision-cache hit
last_sweep_runs: int = 0


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _sync(t) -> None:
    """Wait for the card's work behind ``t`` (nothing on the CPU)."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def chunked_delta_pct(deltas: Sequence[float], ref_s: float) -> float:
    """Median of adjacent-pair deltas over third-sized chunks, best chunk
    wins, as a percentage of ``ref_s`` (negative: the "on" leg is
    faster)."""
    if not deltas or ref_s <= 0:
        return 0.0
    third = max(1, len(deltas) // 3)
    cands = [median(deltas[i:i + third])
             for i in range(0, len(deltas) - third + 1, third)]
    return min(cands) / ref_s * 100.0


def paired_interleave(fn_on, fn_off, pairs: int = 12,
                      warmup: int = 2) -> Dict[str, float]:
    """Interleaved A/B timing of two thunks, each of which must wait for
    its work to finish.  The order alternates per pair so drift cancels;
    returns the legs' median times and the chunked delta of on against
    off."""
    global last_sweep_runs
    for _ in range(warmup):
        fn_on()
        fn_off()
    on_times: List[float] = []
    off_times: List[float] = []
    deltas: List[float] = []
    for i in range(pairs):
        if i % 2 == 0:
            t_on = _timed(fn_on)
            t_off = _timed(fn_off)
        else:
            t_off = _timed(fn_off)
            t_on = _timed(fn_on)
        on_times.append(t_on)
        off_times.append(t_off)
        deltas.append(t_on - t_off)
        last_sweep_runs += 2
    off_med = median(off_times)
    return {
        "on_med_s": median(on_times),
        "off_med_s": off_med,
        "delta_pct": round(chunked_delta_pct(deltas, off_med), 3),
        "pairs": pairs,
    }


# -- knob sweeps -------------------------------------------------------------
def sweep_superstep_k(stepper, data, label,
                      ks: Sequence[int] = (2, 4, 8),
                      pairs: int = 6) -> dict:
    """Each K candidate on the live compiler: one ``superstep`` over K
    copies of the batch against K sequential ``step`` calls, per-step wall
    time both ways.  A candidate that demoted (no superstep ran) is
    recorded ineligible, not scored.  Returns ``{"best_k", "table"}``;
    K=1 wins when no candidate beat its own whole-step baseline."""
    table: Dict[str, dict] = {}
    best_k, best_per_step = 1, None
    for k in ks:
        datas = [data] * k
        labels = [label] * k

        def fn_super():
            _sync(stepper.superstep(datas, labels))

        def fn_seq():
            for d, l in zip(datas, labels):
                _sync(stepper.step(d, l))

        stepper._super_ran = False
        r = paired_interleave(fn_super, fn_seq, pairs=pairs)
        ran = stepper.super_active
        per_step_ms = r["on_med_s"] / k * 1e3
        base_ms = r["off_med_s"] / k * 1e3
        table[str(k)] = {
            "superstep_ms_per_step": round(per_step_ms, 4),
            "wholestep_ms_per_step": round(base_ms, 4),
            "delta_pct": r["delta_pct"],
            "scanned": bool(ran),
        }
        if not ran:
            continue
        if best_per_step is None or per_step_ms < best_per_step:
            best_per_step, best_k = per_step_ms, k
    if best_per_step is not None:
        base = min(float(t["wholestep_ms_per_step"])
                   for t in table.values())
        if base <= best_per_step:
            best_k = 1
    return {"best_k": int(best_k), "table": table}


def sweep_bucket_size(sig, candidates_mb: Sequence[float] = (8, 32, 128),
                      iters: int = 6, device=None) -> dict:
    """The gradient bucketer's flatten and unflatten round trip per
    ``MXNET_BUCKET_SIZE_MB`` candidate, on ``device``: the part of the
    step the knob moves on one card.  ``sig``: the trainer's (shape, dtype
    name) gradient signature."""
    global last_sweep_runs
    from ..kvstore import GradBucketer
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    grads = [torch.ones(tuple(shape), dtype=getattr(torch, dtype),
                        device=device) for shape, dtype in sig]
    table: Dict[str, dict] = {}
    best_mb, best_s = None, None
    for mb in candidates_mb:
        bk = GradBucketer(sig, int(float(mb) * 1024 * 1024))

        def roundtrip(_bk=bk):
            out = _bk.unflatten(_bk.flatten(grads))
            _sync(out[0])
        roundtrip()
        times = []
        for _ in range(iters):
            times.append(_timed(roundtrip))
            last_sweep_runs += 1
        med = median(times)
        table[str(mb)] = {"med_ms": round(med * 1e3, 4),
                          "buckets": len(bk.sizes)}
        if best_s is None or med < best_s:
            best_s, best_mb = med, float(mb)
    return {"best_mb": best_mb, "table": table}


# -- observation-derived serving knobs ---------------------------------------
def lattice_from_traffic(sizes: Sequence[int], max_batch: int,
                         max_rungs: int = 6) -> List[int]:
    """A serving batch lattice from observed batch sizes: the p50, p75,
    p90 and p99 rounded up to powers of two, plus ``max_batch``; at most
    ``max_rungs`` rungs (the closest pair merges first)."""
    mb = max(1, int(max_batch))
    obs = sorted(int(s) for s in sizes if 0 < int(s) <= mb)
    if not obs:
        from ..serving.buckets import pow2_buckets
        return pow2_buckets(mb)

    def _pow2_up(n: int) -> int:
        p = 1
        while p < n:
            p <<= 1
        return min(p, mb)

    rungs = {mb}
    for q in (0.50, 0.75, 0.90, 0.99):
        rungs.add(_pow2_up(obs[min(len(obs) - 1,
                                   int(q * (len(obs) - 1)))]))
    out = sorted(rungs)
    while len(out) > max_rungs:
        gaps = [(out[i + 1] - out[i], i) for i in range(len(out) - 1)]
        _, i = min(gaps)
        out.pop(i)
    return out


def max_wait_from_ewma(dispatch_ewma_ms: Optional[float],
                       floor_ms: float = 0.25,
                       cap_ms: float = 5.0) -> float:
    """``MicroBatcher`` hold window: half a measured dispatch, within
    [floor, cap]; 2 ms (the default) when nothing was measured."""
    if not dispatch_ewma_ms or dispatch_ewma_ms <= 0:
        return 2.0
    return round(min(cap_ms, max(floor_ms, 0.5 * dispatch_ewma_ms)), 3)


def _serve_dispatch_ewma() -> Optional[float]:
    """The flight recorder's EWMA (seconds) of ``serve_dispatch``: its
    watchdog's, else the same EWMA over the ring's recorded spans."""
    from ..observability import flight as _flight
    e = _flight.watch_ewma("serve_dispatch")
    if e is not None:
        return e
    durs = [(r[3] - r[2]) / 1e6 for _, r in _flight.records()
            if r[0] == "serve_dispatch" and r[3] > r[2]]
    if not durs:
        return None
    e = durs[0]
    for d in durs[1:]:
        e = _flight._ALPHA * d + (1.0 - _flight._ALPHA) * e
    return e


# -- the tuner ---------------------------------------------------------------
def tune(net, loss_fn, trainer, data, label,
         ks: Sequence[int] = (2, 4, 8), pairs: int = 6,
         bucket_candidates_mb: Sequence[float] = (8, 32, 128),
         serve_traffic: Optional[Sequence[int]] = None,
         serve_max_batch: Optional[int] = None,
         apply_env: bool = True, force: bool = False,
         serve_signature: Optional[str] = None,
         serve_dispatch_ewma_s: Optional[float] = None) -> Optional[dict]:
    """Run the measured sweeps for this (model, card) and persist the
    decision; a persisted one short-circuits the sweep
    (``last_sweep_runs == 0``) unless ``force``.  Needs ``MXNET_AUTOTUNE``
    on; turns ``MXNET_WHOLE_STEP`` on for its duration.  The net and the
    data live where the caller put them (``gpu(0)`` by default; a net on
    ``cpu()`` is tuned on the CPU).  ``apply_env`` exports
    ``MXNET_PREFETCH_DEPTH=K`` unless the user pinned it.

    The serving knobs (``serve_buckets``, ``serve_max_wait_ms``) are also
    filed under ``serve_signature`` (a ``BucketSpec.signature``), which is
    what a ``BucketedPredictor`` and its ``MicroBatcher`` look up: filed
    under the training model's signature alone, as the JAX package files
    them, no serving spec would read them.  ``serve_dispatch_ewma_s``
    gives the serving dispatch EWMA read from the flight recorder earlier
    (``_serve_dispatch_ewma``), else it is read now.  Returns the
    decision record (with ``evidence.sweep_runs``)."""
    global last_sweep_runs
    if not _decisions.ENABLED:
        logger.warning("autotune.tune() called with MXNET_AUTOTUNE "
                       "disabled — no sweep, no decision")
        return None
    last_sweep_runs = 0
    from .superstep import SuperStepCompiler

    saved_ws = os.environ.get("MXNET_WHOLE_STEP")
    if not getenv("MXNET_WHOLE_STEP", False):
        os.environ["MXNET_WHOLE_STEP"] = "1"
    try:
        stepper = net if isinstance(net, SuperStepCompiler) else \
            SuperStepCompiler(net, loss_fn, trainer)
        # builds the step (and resolves deferred shapes)
        stepper.step(data, label)
        stepper.step(data, label)
        sig = stepper.decision_signature
        if sig is None:
            logger.warning("autotune: model not whole-step capable "
                           "(%s) — nothing to tune",
                           stepper.fallback_reason)
            return None
        device = stepper._built["device"]
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise MXNetError("autotune.tune: the net lives on a CUDA "
                             "device and no CUDA device is available")
        rec = None if force else _decisions.load(sig)
        if rec is not None:
            logger.info("autotune: decision cache hit for %s — zero "
                        "sweep runs", sig)
            return rec
        k_sweep = sweep_superstep_k(stepper, data, label, ks=ks,
                                    pairs=pairs)
        bucket_sweep = sweep_bucket_size(
            stepper._built["sig"], candidates_mb=bucket_candidates_mb,
            device=device)
        knobs = {
            "superstep_k": k_sweep["best_k"],
            "bucket_size_mb": bucket_sweep["best_mb"],
            "prefetch_depth": max(2, k_sweep["best_k"]),
        }
        ewma = serve_dispatch_ewma_s if serve_dispatch_ewma_s is not None \
            else _serve_dispatch_ewma()
        knobs["serve_max_wait_ms"] = max_wait_from_ewma(
            ewma * 1e3 if ewma else None)
        if serve_traffic and serve_max_batch:
            knobs["serve_buckets"] = ",".join(
                str(b) for b in lattice_from_traffic(serve_traffic,
                                                     serve_max_batch))
        evidence = {
            "sweep_runs": last_sweep_runs,
            "superstep": k_sweep["table"],
            "bucket_size": bucket_sweep["table"],
            "serve_dispatch_ewma_ms":
                round(ewma * 1e3, 4) if ewma else None,
            "batch_shape": list(data.shape) if hasattr(data, "shape")
            else None,
        }
        rec = {"schema": 1, "signature": sig, "knobs": knobs,
               "evidence": evidence}
        path = _decisions.store(sig, knobs, evidence)
        if serve_signature is not None:
            _decisions.store(serve_signature, {
                k: v for k, v in knobs.items()
                if k in ("serve_buckets", "serve_max_wait_ms")}, evidence)
        if path:
            rec = _decisions.load(sig)
        if apply_env and "MXNET_PREFETCH_DEPTH" not in os.environ:
            os.environ["MXNET_PREFETCH_DEPTH"] = \
                str(knobs["prefetch_depth"])
        return rec
    finally:
        if saved_ws is None:
            os.environ.pop("MXNET_WHOLE_STEP", None)
        else:
            os.environ["MXNET_WHOLE_STEP"] = saved_ws
