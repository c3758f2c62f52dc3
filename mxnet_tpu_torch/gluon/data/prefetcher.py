"""Prefetch-to-device pipeline: overlap the host-to-device copy of batch
N+1 with the compute of batch N (parity:
``mxnet_tpu/gluon/data/prefetcher.py``).

The reference hides input latency with dmlc::ThreadedIter
double-buffering (src/io/iter_prefetcher.h).  Here a background thread
reads the next batch and, with a CUDA destination, stages each host
tensor in pinned memory and copies it to the card with ``non_blocking``
on a side stream of its own, recording an event: the port's idiom for
the JAX package's ``jax.device_put`` of the next batch.  The consumer's
stream waits on that event when it takes the batch, and
``record_stream`` tells the caching allocator that the consumer's stream
uses the batch, so its memory is not handed out again while a step still
reads it.  The consumer-side stall is the ``mxnet_prefetch_wait_seconds``
histogram.

`AsyncPrefetcher` is the shared core (also backing `io.PrefetchingIter`);
`prefetch_to_device(it, depth=2)` is the user-facing wrapper for any batch
iterable (DataLoader, DataIter, generator).
"""
from __future__ import annotations

import logging
import queue as _queue
import threading
import time as _time

import torch

from ...analysis import sanitizer as _san
from ...base import getenv
from ...faultinject import fire as _fi_fire
from ...observability import flight as _flight
from ...observability import memory as _memory
from ...observability import metrics as _metrics
from ...resilience import (DataCorruptionError, DataSkipBudgetError,
                           classify as _classify, TRANSIENT as _TRANSIENT)

log = logging.getLogger(__name__)

# end-of-stream sentinel (not None: sources may legitimately yield None)
_END = object()

_live_prefetchers = None  # weakref.WeakSet, created lazily


def _register(p) -> None:
    """Track live prefetchers and stop them atexit: a daemon worker in
    the middle of a device copy at interpreter teardown can abort the
    process."""
    global _live_prefetchers
    if _live_prefetchers is None:
        import atexit
        import weakref
        _live_prefetchers = weakref.WeakSet()
        atexit.register(_close_live_prefetchers)
    _live_prefetchers.add(p)


def _close_live_prefetchers() -> None:
    for p in list(_live_prefetchers or ()):
        try:
            p.close()
        except Exception:
            pass


class AsyncPrefetcher:
    """Bounded background-thread prefetch over a `next()`-style source.

    The worker calls `next_fn()` (StopIteration ends the stream), applies
    `transform` (e.g. device placement) still on the worker thread, and
    feeds a queue of `depth` ready batches.  Worker exceptions re-raise in
    the consumer on `get()`, followed by StopIteration — a consumer that
    swallows the error won't hang.

    Fault containment:

    * a TRANSIENT IO error from the source (resilience.classify —
      OSError/timeout/UNAVAILABLE, or an injected `data.batch` fault)
      respawns the worker ONCE per prefetcher after a short backoff
      (`mxnet_prefetch_respawns_total`); a second transient surfaces to
      the consumer exactly as before.
    * a `DataCorruptionError` (undecodable record) is SKIPPED while the
      `skip_budget` lasts (default `MXNET_DATA_SKIP_BUDGET`, 0 = every
      corrupt record surfaces); each skip counts
      `mxnet_data_records_skipped_total`, and exhausting the budget
      surfaces a typed `DataSkipBudgetError` — one bad record can't
      kill an epoch, but systemically damaged data still fails loudly."""

    _MAX_RESPAWNS = 1
    _RESPAWN_BACKOFF_S = 0.05

    def __init__(self, next_fn, depth=None, transform=None,
                 observe_wait: bool = False, skip_budget=None):
        self._next_fn = next_fn
        self._transform = transform
        # default depth 2 unless MXNET_PREFETCH_DEPTH overrides it (the
        # autotuner exports depth>=K so a K-superstep consumer always
        # finds its whole batch group staged); an explicit arg wins
        if depth is None:
            depth = int(getenv("MXNET_PREFETCH_DEPTH", 2))
        self._skip_budget = int(getenv("MXNET_DATA_SKIP_BUDGET", 0)) \
            if skip_budget is None else int(skip_budget)
        self.respawns = 0
        self.skipped = 0
        # prefetch_to_device consumers observe their stalls into the
        # prefetch_wait histogram; io.PrefetchingIter keeps recording
        # into DATA_WAIT_SECONDS itself — one histogram per wait, never
        # both
        self._observe_wait = observe_wait
        self._depth = max(1, int(depth))
        self._queue: _queue.Queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._done = False
        # guards self._thread: written by close() (consumer) AND by the
        # respawn path (worker hands the stream to its replacement)
        self._tlock = _san.make_lock("prefetcher.thread")
        _register(self)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                # chaos site: fires before the source read, so an
                # injected raise models a read that failed WITHOUT
                # consuming a record (a skip/respawn then re-reads the
                # same record — the stream content is unchanged); a real
                # decoder raising DataCorruptionError mid-read genuinely
                # drops that record
                _fi_fire("data.batch")
                item = self._next_fn()
                if self._transform is not None:
                    # device placement (h2d) happens HERE on the worker
                    # thread — the flight span attributes the transfer
                    # to the producer, not the consumer's wait (and the
                    # ledger attributes the staged batch to "prefetch")
                    with _flight.phase_span("prefetch_h2d", cat="io",
                                            mem=True), \
                            _memory.memory_scope("prefetch"):
                        item = self._transform(item)
            except StopIteration:
                self._queue.put(_END)
                return
            except DataCorruptionError as e:
                if self.skipped < self._skip_budget:
                    self.skipped += 1
                    if _metrics.ENABLED:
                        _metrics.DATA_RECORDS_SKIPPED.inc()
                    log.warning(
                        "prefetcher: skipping corrupt record (%s) — "
                        "%d/%d of MXNET_DATA_SKIP_BUDGET used", e,
                        self.skipped, self._skip_budget)
                    continue
                if self._skip_budget == 0:
                    err: BaseException = e  # skipping never opted into
                else:
                    err = DataSkipBudgetError(
                        f"corrupt-record skip budget exhausted "
                        f"({self._skip_budget} records already skipped; "
                        f"next: {e}) — the input data is damaged beyond "
                        "MXNET_DATA_SKIP_BUDGET")
                    err.__cause__ = e
                self._queue.put(err)
                self._queue.put(_END)
                return
            except BaseException as e:  # surface in the consumer thread
                if self.respawns < self._MAX_RESPAWNS and \
                        not self._stop.is_set() and \
                        _classify(e) is _TRANSIENT:
                    # transient source hiccup (flaky NFS, dropped
                    # connection, injected chaos): hand the stream to a
                    # fresh worker once instead of killing the epoch
                    self.respawns += 1
                    if _metrics.ENABLED:
                        _metrics.PREFETCH_RESPAWNS.inc()
                    log.warning(
                        "prefetcher: worker hit transient %s: %s — "
                        "respawning (%d/%d)", type(e).__name__, e,
                        self.respawns, self._MAX_RESPAWNS)
                    _time.sleep(self._RESPAWN_BACKOFF_S)
                    t = threading.Thread(target=self._worker, daemon=True)
                    with self._tlock:
                        if self._stop.is_set():
                            return  # closed during the backoff window
                        self._thread = t
                    t.start()
                    return
                self._queue.put(e)
                self._queue.put(_END)
                return
            self._queue.put(item)

    def get(self):
        """Next ready batch; blocks only when the pipeline is behind (the
        stall is the prefetch_wait histogram).  Exhaustion is sticky:
        every get() after the stream ends raises StopIteration instead
        of blocking on the drained queue."""
        if self._done:
            raise StopIteration
        on = _metrics.ENABLED and self._observe_wait
        t0 = _time.perf_counter() if on else 0.0
        with _flight.phase_span("prefetch_wait", cat="io"):
            item = self._queue.get()
        if on:
            _metrics.PREFETCH_WAIT_SECONDS.observe(_time.perf_counter() - t0)
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        if isinstance(item, _Staged):
            item = item.take()
        return item

    def close(self) -> None:
        """Stop the worker and drain the buffer (idempotent); any later
        get() raises StopIteration."""
        self._done = True
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        with self._tlock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _resolve_device(device):
    """Context / torch.device / str / None -> torch.device (None: the
    current context's)."""
    from ...context import as_device
    return as_device(device)


class _Staged:
    """A batch copied to the card on the prefetcher's side stream, with the
    event its consumer's stream waits on."""

    __slots__ = ("batch", "event", "tensors")

    def __init__(self, batch, event, tensors):
        self.batch = batch
        self.event = event
        self.tensors = tensors

    def take(self):
        """The batch, usable on the calling thread's current stream."""
        if self.event is not None:
            cur = torch.cuda.current_stream(self.event_device())
            cur.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(cur)
        return self.batch

    def event_device(self):
        return self.tensors[0].device if self.tensors else None


_side_streams = {}


def _side_stream(dev):
    """The prefetchers' copy stream for ``dev``, made once."""
    s = _side_streams.get(dev)
    if s is None:
        s = _side_streams.setdefault(dev, torch.cuda.Stream(dev))
    return s


def _device_put_batch(batch, dev):
    """Copy a batch (tensor / DataBatch / list / tuple / numpy) to ``dev``.
    Tensors already there pass through.  For a CUDA destination the host
    tensors go through pinned staging buffers and a ``non_blocking`` copy
    on a side stream; the result is a ``_Staged`` that the consumer takes
    (``AsyncPrefetcher.get``)."""
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    moved = []
    stream = _side_stream(dev) if cuda else None

    def leaf(x):
        if isinstance(x, torch.Tensor) or (
                hasattr(x, "shape") and hasattr(x, "dtype")
                and not isinstance(x, torch.Tensor)):
            if not isinstance(x, torch.Tensor):
                from ...ndarray.ndarray import array
                x = array(x, ctx=torch.device("cpu"))
            if x.device == dev:
                return x
            if cuda and x.device.type == "cpu":
                host = x if x.is_pinned() else x.pin_memory()
                out = host.to(dev, non_blocking=True)
            else:
                out = x.to(dev)
            if _memory.ENABLED:
                _memory.register(out, tag="prefetch")
            moved.append(out)
            return out
        if isinstance(x, (list, tuple)):
            return type(x)(leaf(v) for v in x)
        if hasattr(x, "data") and hasattr(x, "label"):  # io.DataBatch
            x.data = [leaf(v) for v in x.data]
            if x.label is not None:
                x.label = [leaf(v) for v in x.label]
            return x
        return x

    if not cuda:
        return leaf(batch)
    with torch.cuda.stream(stream):
        out = leaf(batch)
        ev = torch.cuda.Event()
        ev.record(stream)
    return _Staged(out, ev, moved)


class _DevicePrefetchIter:
    """Iterator returned by prefetch_to_device: double-buffers device
    placement of upcoming batches in a background thread."""

    def __init__(self, source, depth=None, device=None,
                 skip_budget=None):
        self._source = source
        self._depth = depth
        self._skip_budget = skip_budget
        self._dev = _resolve_device(device)
        self._pf = None
        self._start()

    def _start(self) -> None:
        src = self._source
        next_fn = src.next if hasattr(src, "next") and not hasattr(src, "__next__") \
            else iter(src).__next__
        self._pf = AsyncPrefetcher(
            next_fn, depth=self._depth,
            transform=lambda b: _device_put_batch(b, self._dev),
            observe_wait=True, skip_budget=self._skip_budget)

    def __iter__(self):
        return self

    def __next__(self):
        if self._pf is None:
            raise StopIteration
        return self._pf.get()

    next = __next__

    def reset(self) -> None:
        """Restart the underlying source (DataIter protocol)."""
        self.close()
        if hasattr(self._source, "reset"):
            self._source.reset()
        self._start()

    def close(self) -> None:
        if self._pf is not None:
            self._pf.close()
            self._pf = None

    def __len__(self):
        return len(self._source)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def prefetch_to_device(data_iter, depth=None, device=None,
                       skip_budget=None):
    """Wrap a batch iterable so the next `depth` batches are device-resident
    before the training loop asks for them.

    >>> for batch in prefetch_to_device(loader, depth=2):
    ...     trainer.step(...)   # batch N+1 uploads while step N runs

    depth: queue depth; None reads MXNET_PREFETCH_DEPTH (default 2 —
    the autotuner exports depth>=K when a K-superstep decision lands,
    so the whole K-batch group stages ahead of the scan dispatch).
    device: a Context, a torch.device, or None (the current context's).
    skip_budget: corrupt-record tolerance (default MXNET_DATA_SKIP_BUDGET)
    — see AsyncPrefetcher.
    """
    return _DevicePrefetchIter(data_iter, depth=depth, device=device,
                               skip_budget=skip_budget)
