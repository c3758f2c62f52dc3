"""Shape-bucketed inference executor — the serving fast path.

The counterpart of ``mxnet_tpu/serving/predictor.py``.  A served Symbol
runs at a small fixed lattice of padded shape buckets
(``buckets.BucketSpec``, pow2-derived, ``MXNET_SERVE_BUCKETS`` override):

  - each bucket gets an entry built once (``precompile``): its zero
    placeholders, a check that every output is batch-major, and one
    forward on zeros that warms it (the CUDA kernels of the graph, such as
    the flash-attention kernel, launch there first); ``warmup()`` moves all
    of that off the request path.  The JAX package compiles one executable
    per bucket with ``jax.jit(...).lower().compile()``; the port runs the
    graph eagerly through ``GraphPlan``, so the warm-up forward is what is
    left of a compile;
  - requests pad on the host into the bucket shape (one transfer to the
    device, one graph run per request or coalesced batch) and the valid
    rows are sliced back out on axis 0 only: a request padded along its
    sequence axis gets the bucket's full width back, as in the reference;
  - ``donate`` is accepted and has no effect: PyTorch has no buffer
    donation (as on a JAX backend without donation).

The device is ``gpu(0)`` (the current context) unless ``dev=mx.cpu()`` is
passed; a gpu context without a CUDA device raises ``MXNetError``.  Every
device step runs under ``torch.cuda.device`` of the predictor's device,
since the batcher and server dispatch from threads of their own.

Hot reload from checkpoints (``hot_reload``, ``start_auto_reload``) needs
``checkpoint/`` and raises until it is ported (ROADMAP.md, queue item 4).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as _np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import as_device, cpu, current_context
from .. import ndarray as nd
from ..observability import metrics as _metrics
from .. import symbol as sym_mod
from ..symbol import Symbol
from ..symbol.graph import GraphPlan, meta_tensor
from .buckets import BucketSpec, bucket_label, pad_to_shape

__all__ = ["BucketedPredictor", "ModelEvictedError"]

_CHECKPOINTS = ("checkpoint hot reload needs checkpoint/, which is not "
                "ported yet (ROADMAP.md, queue item 4: the fused step and "
                "checkpoint/)")


class ModelEvictedError(MXNetError):
    """A dispatch or bucket build reached a predictor whose device weights
    are evicted — readmit() and retry."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class BucketedPredictor:
    """Forward-only serving executor over a fixed shape-bucket lattice.

    Parameters
    ----------
    symbol : Symbol or str
        The inference graph (a Symbol, or its JSON from ``tojson()``).
    params : dict / bytes / str
        ``{name: tensor-or-numpy}`` (optionally ``arg:``/``aux:``
        prefixed), a serialized param blob (parsed in memory), or a param
        file path.
    input_shapes : dict
        ``{input_name: shape}`` — axis 0 is the batch axis; the declared
        sizes are the maxima the default pow2 bucket ladders derive from.
    dev : Context, optional
        Where the weights live and the graph runs (default: the current
        context, ``gpu(0)``).
    seq_axes : dict, optional
        ``{input_name: axis}`` marking a second bucketed (sequence) axis.
        Sequence padding is exact only for models whose valid positions
        do not see the padding (a causal LM's do not).
    input_dtypes : dict, optional
        ``{input_name: dtype}`` of the request payloads (default float32:
        token ids stay float32 as the ops take them, under bfloat16
        weights too).
    donate : bool
        Accepted for parity and ignored: PyTorch has no buffer donation.
    """

    def __init__(self, symbol, params, input_shapes: Dict[str, tuple],
                 dev=None, batch_buckets=None, seq_axes=None,
                 seq_buckets=None, input_dtypes=None,
                 output_names: Optional[Sequence[str]] = None,
                 donate: bool = True):
        from ..predictor import load_param_payload, split_arg_aux
        sym = symbol if isinstance(symbol, Symbol) \
            else sym_mod.load_json(symbol)
        if output_names:
            internals = sym.get_internals()
            sym = sym_mod.Group([internals[n] for n in output_names])
        self._symbol = sym
        self._ctx = dev if dev is not None else current_context()
        self._device = as_device(self._ctx)  # raises for gpu without CUDA
        self._plan = GraphPlan(sym)

        # the host twin of the served weights (CPU tensors, owned copies):
        # evict() drops the device copies and keeps this, so readmit() is
        # one upload per tensor
        arg_params, aux_params = split_arg_aux(
            load_param_payload(params, ctx=cpu()))
        arg_names = sym.list_arguments()
        self._input_names = [n for n in arg_names if n not in arg_params]
        for name in input_shapes:
            if name not in self._input_names:
                raise MXNetError(
                    f"'{name}' is not a free input of the symbol; free "
                    f"inputs: {self._input_names}")
        self._host_payload = (arg_params, aux_params)
        self._closed = False
        # a first admission is not a readmission: only an evict ->
        # readmit cycle counts in SERVE_READMITS
        self._was_evicted = False
        # one tuple holds the live (params, aux) pair, swapped by a single
        # reference assignment
        self._weights = self._upload()
        self._resident = True
        self._input_dtypes = {
            n: np_dtype((input_dtypes or {}).get(n, "float32"))
            for n in input_shapes}
        self.spec = BucketSpec(input_shapes, batch_buckets=batch_buckets,
                               seq_axes=seq_axes, seq_buckets=seq_buckets)
        self._compiled: Dict[tuple, dict] = {}   # key -> bucket input shapes
        self._extra: Dict[tuple, dict] = {}      # per-bucket zero placeholders
        # the keys ever built: rebuilding an evicted bucket is a
        # readmission, not an escape from the bucket set
        self._ever_compiled: set = set()
        self._mem_stats: Dict[tuple, dict] = {}
        # builds may be triggered concurrently by the batcher and direct
        # callers; the lock keeps "build each bucket once" true and guards
        # the weights lifecycle (reentrant: evict() nests evict_bucket())
        self._compile_lock = threading.RLock()

    def _upload(self):
        host_p, host_a = self._host_payload
        return ({k: v.to(self._device) for k, v in host_p.items()},
                {k: v.to(self._device) for k, v in host_a.items()})

    @property
    def _params(self) -> dict:
        return self._weights[0]

    @property
    def _aux(self) -> dict:
        return self._weights[1]

    def _on_device(self):
        """The predictor's CUDA device as the current one (a thread's
        current device is its own), or nothing on the CPU."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    # -- bucket entries ------------------------------------------------------
    def _placeholder_shapes(self, in_shapes: dict) -> dict:
        """Zero placeholders for free args not served as inputs (label
        heads of training symbols — MXPredCreate parity)."""
        missing = [n for n in self._input_names if n not in in_shapes]
        if not missing:
            return {}
        arg_shapes, _, _ = self._symbol.infer_shape_partial(**in_shapes)
        inferred = dict(zip(self._symbol.list_arguments(), arg_shapes or []))
        out = {}
        for name in missing:
            shp = inferred.get(name)
            if shp is None:
                raise MXNetError(
                    f"input '{name}' has no declared shape and shape "
                    f"inference could not determine one")
            out[name] = tuple(shp)
        return out

    def _out_shapes(self, in_shapes: dict, extra: dict) -> list:
        """The outputs' shapes at one bucket, from a run of the graph on
        meta tensors (no data, no kernel launch)."""
        args = {k: meta_tensor(v.shape, v.dtype)
                for d in (self._params, extra) for k, v in d.items()}
        args.update({n: meta_tensor(s, self._input_dtypes[n])
                     for n, s in in_shapes.items()})
        aux = {k: meta_tensor(v.shape, v.dtype) for k, v in self._aux.items()}
        outs, _ = self._plan.run(args, aux)
        return [tuple(o.shape) for o in outs]

    def _run(self, data: dict, extra: dict, weights) -> list:
        params, aux = weights
        merged = dict(params)
        merged.update(extra)
        merged.update(data)
        with torch.no_grad():
            outs, _ = self._plan.run(merged, aux)
        return outs

    def precompile(self, key: tuple) -> dict:
        """Build and warm one bucket's entry (idempotent): placeholders,
        the batch-major check, one forward on zeros."""
        if key in self._compiled:
            return self._compiled[key]
        with self._compile_lock, self._on_device():
            if key in self._compiled:
                return self._compiled[key]
            if not self._resident:
                raise ModelEvictedError(
                    "model weights are evicted — readmit() before "
                    "building or serving buckets")
            in_shapes = self.spec.bucket_input_shapes(key)
            extra = {n: torch.zeros(s, device=self._device)
                     for n, s in self._placeholder_shapes(in_shapes).items()}
            # bucket padding is only sound for batch-major outputs (valid
            # rows slice back out on axis 0): reject scalar or
            # non-batch-major outputs here instead of serving corrupted
            # values
            out_shapes = self._out_shapes(in_shapes, extra)
            bad = [s for s in out_shapes if len(s) < 1 or s[0] != key[0]]
            if bad:
                raise MXNetError(
                    f"output shapes {out_shapes} are not batch-major "
                    f"(axis 0 != bucket batch {key[0]}): this symbol "
                    f"cannot be served through bucket padding")
            zeros = {n: torch.zeros(s, dtype=torch_dtype(
                self._input_dtypes[n]), device=self._device)
                for n, s in in_shapes.items()}
            cuda = self._device.type == "cuda"
            if cuda:
                torch.cuda.reset_peak_memory_stats(self._device)
                base = torch.cuda.memory_allocated(self._device)
            self._run(zeros, extra, self._weights)
            if cuda:
                peak = torch.cuda.max_memory_allocated(self._device) - base
                self._mem_stats[key] = {"peak_bytes": int(peak)}
                if _metrics.ENABLED:
                    _metrics.SERVE_BUCKET_HBM_BYTES.set(
                        peak, bucket=bucket_label(key))
            if _metrics.ENABLED:
                _metrics.SERVE_COMPILES.inc()
                if key in self._ever_compiled:
                    # an evicted bucket rebuilt: a build and a readmission
                    _metrics.SERVE_READMITS.inc(kind="bucket")
            self._ever_compiled.add(key)
            self._extra[key] = extra
            self._compiled[key] = in_shapes
            return in_shapes

    def warmup(self, keys=None) -> "BucketedPredictor":
        """Build every bucket (or the given keys) ahead of traffic: after
        this, a request inside the bucket set builds nothing."""
        for key in (keys if keys is not None else self.spec.all_keys()):
            self.precompile(tuple(key))
        return self

    @property
    def num_compiled(self) -> int:
        return len(self._compiled)

    def memory_stats(self) -> dict:
        """Per-bucket peak device bytes of the warm-up forward (CUDA only;
        ``torch.cuda.max_memory_allocated`` above what was allocated
        before it) and this instance's live weight + placeholder bytes."""
        stats = dict(self._mem_stats)
        resident = set(self._compiled)
        per_bucket = {}
        for k, v in sorted(stats.items()):
            d = dict(v)
            d["resident"] = k in resident
            per_bucket[bucket_label(k)] = d
        live = [v for v in per_bucket.values() if v["resident"]]
        params, aux = self._weights
        weights = sum(_nbytes(a) for d in (params, aux) for a in d.values())
        weights += sum(_nbytes(a) for ph in dict(self._extra).values()
                       for a in ph.values())
        return {
            "buckets": per_bucket,
            "resident": self._resident,
            "peak_bytes_max": max((v["peak_bytes"] for v in live),
                                  default=0),
            "peak_bytes_total": sum(v["peak_bytes"] for v in live),
            "weights_bytes": int(weights),
        }

    # -- serving -------------------------------------------------------------
    def _as_host(self, name: str, value) -> _np.ndarray:
        """Request payloads normalize to host numpy in the declared input
        dtype (serving's contract is host-in/host-out; tensors on a device
        are fetched)."""
        if isinstance(value, torch.Tensor):
            value = nd.asnumpy(value)
        arr = _np.asarray(value)
        dt = self._input_dtypes[name]
        if arr.dtype != dt:
            arr = arr.astype(dt)
        return arr

    def _served_names(self) -> list:
        return [n for n in self._input_names
                if n in self.spec.input_shapes]

    def _check_names(self, inputs) -> None:
        served = self._served_names()
        if set(inputs) != set(served):
            raise MXNetError(
                f"request needs exactly inputs {served}, got "
                f"{sorted(inputs)}")

    def _check_request(self, inputs: Dict[str, _np.ndarray]) -> None:
        """Validate one request's input set and geometry up front: exact
        served-input names, fixed (non-bucketed) dims matching the
        declared template, sequence inside the largest seq bucket, one
        agreed batch size.  The micro-batcher runs this at submit() so a
        malformed request fails alone instead of poisoning its group."""
        self._check_names(inputs)
        for n, a in inputs.items():
            tmpl = self.spec.input_shapes[n]
            if len(a.shape) != len(tmpl):
                raise MXNetError(
                    f"input '{n}': rank {len(a.shape)} != declared "
                    f"rank {len(tmpl)} {tmpl}")
            ax_seq = self.spec.seq_axes.get(n)
            for i in range(1, len(tmpl)):
                if i != ax_seq and a.shape[i] != tmpl[i]:
                    raise MXNetError(
                        f"input '{n}' dim {i} is {a.shape[i]}, declared "
                        f"{tmpl[i]} (only batch/seq axes may vary)")
        self.spec.route({n: a.shape for n, a in inputs.items()})

    def _dispatch(self, key: tuple, padded: dict) -> list:
        """One graph run at bucket ``key`` on padded host inputs; returns
        the outputs on the device."""
        self.precompile(key)
        extra = self._extra.get(key)
        if extra is None:
            # a concurrent bucket eviction between build and here: one
            # rebuild keeps the failure typed
            self.precompile(key)
            extra = self._extra.get(key)
            if extra is None:
                raise ModelEvictedError(
                    f"bucket {key} evicted mid-dispatch — retry")
        if _metrics.ENABLED:
            _metrics.SERVE_BATCHES.inc()
        # one read: a concurrent evict cannot tear the pair
        weights = self._weights
        if not weights[0] and not weights[1] and not self._resident:
            raise ModelEvictedError(
                "model weights were evicted between build and dispatch — "
                "readmit() and retry")
        with self._on_device():
            data = {n: nd.array(a, ctx=self._device)
                    for n, a in padded.items()}
            return self._run(data, extra, weights)

    def _predict_routed(self, inputs: Dict[str, _np.ndarray]) -> list:
        shapes = {n: a.shape for n, a in inputs.items()}
        key = self.spec.route(shapes)
        rows = next(iter(shapes.values()))[0]
        if key[0] is None:
            # larger than the biggest bucket: chunk over it
            cap = self.spec.max_batch
            outs_per_chunk = [
                self._predict_routed({n: a[lo:lo + cap]
                                      for n, a in inputs.items()})
                for lo in range(0, rows, cap)]
            return [_np.concatenate(parts, axis=0)
                    for parts in zip(*outs_per_chunk)]
        bucket_shapes = self.spec.bucket_input_shapes(key)
        padded = {n: pad_to_shape(a, bucket_shapes[n])
                  for n, a in inputs.items()}
        if _metrics.ENABLED:
            _metrics.SERVE_PADDING_WASTE.set(
                self.spec.waste_fraction(key, shapes))
        outs = self._dispatch(key, padded)
        # the valid rows, on axis 0 only (batch padding is dead rows at
        # the tail; the output's sequence layout is the model's), copied
        # to the host: the request's one device-to-host copy
        return [nd.asnumpy(o[:rows]) for o in outs]

    def predict(self, *args, **kwargs) -> List[_np.ndarray]:
        """Run one request: positional args follow the symbol's input
        order, kwargs go by input name.  Returns host numpy outputs
        sliced to the request's valid rows."""
        served = self._served_names()
        if args:
            if kwargs or len(args) > len(served):
                raise MXNetError(
                    f"predict takes inputs {served} (got {len(args)} "
                    f"positional + {sorted(kwargs)})")
            kwargs = dict(zip(served, args))
        self._check_names(kwargs)
        t0 = time.perf_counter()
        inputs = {n: self._as_host(n, v) for n, v in kwargs.items()}
        self._check_request(inputs)
        outs = self._predict_routed(inputs)
        if _metrics.ENABLED:
            _metrics.SERVE_REQUESTS.inc()
            _metrics.SERVE_LATENCY_SECONDS.observe(time.perf_counter() - t0)
        return outs

    # C-predict-API-shaped alias (MXPredForward parity)
    forward = predict

    # -- eviction / readmission ----------------------------------------------
    @property
    def resident(self) -> bool:
        """False after evict(): device weights and every bucket entry are
        dropped; only the host param payload remains."""
        return self._resident

    def evict_bucket(self, key: tuple) -> int:
        """Drop one bucket's entry and zero placeholders.  Returns the
        estimated device bytes freed; idempotent."""
        with self._compile_lock:
            if key not in self._compiled:
                return 0
            freed = int(self._mem_stats.get(key, {}).get("peak_bytes", 0))
            freed += sum(_nbytes(a)
                         for a in self._extra.get(key, {}).values())
            del self._compiled[key]
            self._extra.pop(key, None)
            if _metrics.ENABLED:
                _metrics.SERVE_BUCKET_HBM_BYTES.remove(
                    bucket=bucket_label(key))
            return freed

    def evict(self) -> int:
        """Drop every bucket entry, every placeholder and the device
        weights; the host payload stays, so ``readmit()`` is a reload and
        a rebuild, never a restart.  Returns estimated device bytes freed.
        New dispatches raise a typed ``ModelEvictedError``."""
        with self._compile_lock:
            # residency flips first: a racing dispatch sees either the
            # full old pair or the empty pair and the flag
            self._resident = False
            self._was_evicted = True
            freed = sum(self.evict_bucket(k) for k in list(self._compiled))
            params, aux = self._weights
            freed += sum(_nbytes(a) for d in (params, aux)
                         for a in d.values())
            self._weights = ({}, {})
            return freed

    def readmit(self) -> None:
        """Upload the host payload again and mark the model servable.
        Bucket entries rebuild at the next dispatch per key (counted as
        ``mxnet_serve_readmissions_total{kind="bucket"}``).  Idempotent."""
        with self._compile_lock:
            if self._resident:
                return
            if self._closed:
                raise MXNetError("predictor is closed")
            self._weights = self._upload()
            self._resident = True
            was_evicted = self._was_evicted
        if was_evicted and _metrics.ENABLED:
            _metrics.SERVE_READMITS.inc(kind="model")

    def close(self) -> None:
        """Drop the device weights, bucket entries and the host payload.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        with self._compile_lock:
            self.evict()
            self._host_payload = ({}, {})
            self._mem_stats.clear()
            self._ever_compiled.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- checkpoint hot reload -----------------------------------------------
    def hot_reload(self, source, step=None) -> int:
        raise NotImplementedError(f"hot_reload: {_CHECKPOINTS}")

    def start_auto_reload(self, source, interval_s: float = 30.0) -> None:
        raise NotImplementedError(f"start_auto_reload: {_CHECKPOINTS}")
