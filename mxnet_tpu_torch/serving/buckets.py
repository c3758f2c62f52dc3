"""Shape-bucket geometry for the serving fast path.

The counterpart of ``mxnet_tpu/serving/buckets.py``, its logic unchanged.
A served graph runs at a small fixed set of padded shapes: every request
routes to the smallest covering bucket, so the set of shapes the model ever
sees is known before traffic (``BucketedPredictor.warmup`` builds and
warms each one).  This is the bucketing-executor design of MXNet (arxiv
1512.01274 §4) applied to serving.

Bucket derivation follows the pow2 rule (``1 << (n - 1).bit_length()``):
ascending powers of two up to the pow2 ceiling of the declared maximum,
overridable via ``MXNET_SERVE_BUCKETS`` (batch) and
``MXNET_SERVE_SEQ_BUCKETS`` (sequence).  Padding waste is below 50% per
axis by construction; the number of buckets is O(log max) per axis.

The batch ladder's precedence: the constructor's ``batch_buckets`` >
``MXNET_SERVE_BUCKETS`` > the persisted ``serve_buckets`` decision for
the spec's ``signature`` (``autotune.tune`` derives it from observed
traffic) > pow2.  While ``MXNET_AUTOTUNE`` is on, ``route`` records each
request's batch size in a bounded ring (``observed_traffic``), the tuner's
``lattice_from_traffic`` feed.
"""
from __future__ import annotations

import os
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as _np

from ..autotune import decisions as _decisions
from ..base import MXNetError

__all__ = ["pow2_buckets", "parse_bucket_env", "covering_bucket",
           "pad_to_shape", "BucketSpec", "observed_traffic",
           "page_lattice"]

#: bounded ring of request batch sizes seen by ``BucketSpec.route`` while
#: ``MXNET_AUTOTUNE`` is on (one boolean on the route path otherwise)
_TRAFFIC_MAX = 4096
_traffic: deque = deque(maxlen=_TRAFFIC_MAX)


def observed_traffic() -> Tuple[int, ...]:
    """Request batch sizes routed since process start (newest last)."""
    return tuple(_traffic)


def pow2_buckets(max_n: int, lo: int = 1) -> List[int]:
    """Ascending powers of two from `lo` through the pow2 ceiling of
    `max_n` (the `ndarray/sparse.py:323` rule generalized to a ladder)."""
    if max_n < 1:
        raise MXNetError(f"bucket maximum must be >= 1, got {max_n}")
    lo = max(1, int(lo))
    out, b = [], lo
    while b < max_n:
        out.append(b)
        b <<= 1
    out.append(b)
    return out


def parse_bucket_env(name: str) -> Optional[List[int]]:
    """Parse `MXNET_SERVE_BUCKETS`-style env: a comma list of ints
    (e.g. "1,4,16,64").  Returns None when unset/empty; raises loudly on
    malformed values (a silently-ignored typo here would reintroduce the
    hot-path recompiles the bucket set exists to prevent)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        vals = sorted({int(tok) for tok in raw.replace(";", ",").split(",")
                       if tok.strip()})
    except ValueError:
        raise MXNetError(f"{name}={raw!r}: expected a comma list of ints")
    if not vals or vals[0] < 1:
        raise MXNetError(f"{name}={raw!r}: buckets must be positive ints")
    return vals


def covering_bucket(buckets: Sequence[int], n: int) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds every bucket (the
    caller chunks over the largest bucket)."""
    for b in buckets:  # buckets are sorted ascending and short (~log max)
        if b >= n:
            return b
    return None


def bucket_label(key: tuple) -> str:
    """Compact stable label for a bucket key in flight-recorder records
    ("8" batch-only, "8x128" batch x seq, "chunked" for oversized
    requests riding the largest bucket).  Cardinality is bounded by the
    lattice — one label per bucket, ever — so it is safe to attach to
    timeline spans and summaries."""
    if key and key[0] is None:
        return "chunked"
    return "x".join(str(k) for k in key)


def pad_to_shape(arr: _np.ndarray, shape: Tuple[int, ...]) -> _np.ndarray:
    """Zero-pad a host array up to `shape` (every dim of `arr` must be
    <= the target).  Host-side on purpose: requests arrive from the RPC
    boundary as host memory (MXPredSetInput parity), and padding before
    the single device transfer keeps serving at one transfer and one
    graph run per batch — a device-side pad would cost extra launches."""
    if tuple(arr.shape) == tuple(shape):
        return _np.ascontiguousarray(arr)
    if len(arr.shape) != len(shape) or \
            any(a > s for a, s in zip(arr.shape, shape)):
        raise MXNetError(
            f"cannot pad {arr.shape} up to bucket shape {shape}")
    out = _np.zeros(shape, dtype=arr.dtype)
    out[tuple(slice(0, d) for d in arr.shape)] = arr
    return out


def page_lattice(max_slots: int, max_pages: int, slot_buckets=None,
                 page_buckets=None) -> "BucketSpec":
    """The (slots, pages) lattice continuous-batching decode routes
    over (`serving.decode.DecodeEngine`): axis 0 is decode SLOTS
    (concurrent sequences), the seq axis is KV PAGES — so one stock
    `BucketSpec` covers mixed-length generation the same way it covers
    mixed-size inference batches, and a sequence growing across a page
    boundary re-routes to a neighbouring warmed key.  Explicit pow2
    ladders are always passed down: the decode lattice is engine
    geometry, decoupled from the request-path `MXNET_SERVE_BUCKETS`
    pins."""
    if max_slots < 1 or max_pages < 1:
        raise MXNetError(
            f"page_lattice needs max_slots/max_pages >= 1, got "
            f"({max_slots}, {max_pages})")
    return BucketSpec(
        {"kv": (max_slots, max_pages)},
        batch_buckets=list(slot_buckets) if slot_buckets
        else pow2_buckets(max_slots),
        seq_axes={"kv": 1},
        seq_buckets=list(page_buckets) if page_buckets
        else pow2_buckets(max_pages))


class BucketSpec:
    """The (batch, seq) bucket lattice one served model routes over.

    batch buckets cover axis 0 of every input; seq buckets (optional)
    cover one declared axis per sequence-bearing input (`seq_axes`:
    input name -> axis).  A bucket key is `(batch,)` or `(batch, seq)`.
    """

    def __init__(self, input_shapes: dict, batch_buckets=None,
                 seq_axes: Optional[dict] = None, seq_buckets=None):
        if not input_shapes:
            raise MXNetError("BucketSpec needs at least one input shape")
        self.input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self.seq_axes = dict(seq_axes or {})
        for name, ax in self.seq_axes.items():
            shp = self.input_shapes.get(name)
            if shp is None:
                raise MXNetError(f"seq_axes names unknown input '{name}'")
            if not 0 < ax < len(shp):
                raise MXNetError(
                    f"seq axis {ax} out of range for input '{name}' {shp}")
        batches = {s[0] for s in self.input_shapes.values()}
        if len(batches) != 1:
            raise MXNetError(
                f"inputs disagree on batch (axis 0) size: {input_shapes}")
        self.max_batch_hint = batches.pop()

        def _checked(buckets, what):
            # kwarg-provided ladders get the same validation the env
            # path enforces — a 0/negative bucket would compile a
            # degenerate executable and corrupt covering-bucket routing
            out = sorted(set(int(b) for b in buckets))
            if not out or out[0] < 1:
                raise MXNetError(
                    f"{what} buckets must be positive ints, got "
                    f"{list(buckets)}")
            return out

        # serving decisions key on the declared input surface
        self.signature = _decisions.model_signature(
            sorted(self.input_shapes.items()),
            extra=("serving", tuple(sorted(self.seq_axes.items()))))
        # ladder precedence: ctor arg > MXNET_SERVE_BUCKETS env pin >
        # persisted autotune lattice > pow2 ladder
        decided = None
        if batch_buckets is None \
                and "MXNET_SERVE_BUCKETS" not in os.environ \
                and _decisions.ENABLED:
            knob = _decisions.knob(self.signature, "serve_buckets", None)
            if knob:
                decided = [int(t) for t in str(knob).split(",")]
        self.batch_buckets = _checked(
            batch_buckets or parse_bucket_env("MXNET_SERVE_BUCKETS")
            or decided or pow2_buckets(self.max_batch_hint), "batch")
        if self.seq_axes:
            max_seq = max(self.input_shapes[n][ax]
                          for n, ax in self.seq_axes.items())
            self.seq_buckets = _checked(
                seq_buckets or parse_bucket_env("MXNET_SERVE_SEQ_BUCKETS")
                or pow2_buckets(max_seq), "seq")
        else:
            self.seq_buckets = None

    # -- routing ------------------------------------------------------------
    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def all_keys(self) -> List[tuple]:
        if self.seq_buckets is None:
            return [(b,) for b in self.batch_buckets]
        return [(b, s) for b in self.batch_buckets
                for s in self.seq_buckets]

    def route(self, shapes: dict) -> tuple:
        """Smallest covering bucket key for one request's input shapes
        ({name: shape}).  Raises when the request exceeds the largest
        seq bucket; batch overflow is the caller's chunking problem and
        reported via a None batch component."""
        rows = {s[0] for s in shapes.values()}
        if len(rows) != 1:
            raise MXNetError(f"inputs disagree on batch size: {shapes}")
        n = rows.pop()
        if _decisions.ENABLED:
            _traffic.append(int(n))
        b = covering_bucket(self.batch_buckets, n)
        if self.seq_buckets is None:
            return (b,)
        seq = 0
        for name, ax in self.seq_axes.items():
            if name in shapes:
                seq = max(seq, shapes[name][ax])
        s = covering_bucket(self.seq_buckets, seq)
        if s is None:
            raise MXNetError(
                f"sequence length {seq} exceeds the largest seq bucket "
                f"{self.seq_buckets[-1]}; widen MXNET_SERVE_SEQ_BUCKETS")
        return (b, s)

    def bucket_input_shapes(self, key: tuple) -> dict:
        """Concrete padded input shapes for one bucket key."""
        b = key[0]
        out = {}
        for name, shp in self.input_shapes.items():
            shp = (b,) + tuple(shp[1:])
            ax = self.seq_axes.get(name)
            if ax is not None:
                shp = shp[:ax] + (key[1],) + shp[ax + 1:]
            out[name] = shp
        return out

    def waste_fraction(self, key: tuple, shapes: dict) -> float:
        """Fraction of padded (dead) elements the bucket dispatch will
        compute over — the padding-waste serving gauge."""
        want = sum(int(_np.prod(s)) for s in shapes.values())
        got = sum(int(_np.prod(s))
                  for s in self.bucket_input_shapes(key).values())
        return 1.0 - (want / got) if got else 0.0
