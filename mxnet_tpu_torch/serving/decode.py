"""Continuous batching for generative decode: paged KV serving with
per-step join and leave (parity: ``mxnet_tpu/serving/decode.py``).

``DecodeEngine`` serves one decode model over a slot set:

  * **one CUDA-graph replay per decode step** over the whole in-flight
    slot set (the JAX package's one donated dispatch).  Each (slots, pages)
    key of the lattice (``buckets.page_lattice``) has its own graph,
    captured by ``precompile``/``warmup`` and counted in
    ``SERVE_COMPILES``.  A step copies the tokens, positions and "fresh"
    flags into the key's static input tensor (one host-to-device copy),
    replays the graph, which writes the decode state in place and the next
    tokens into a static output, and reads the next tokens back once.
    Sequences join and leave between steps; churn never changes the
    number of replays.  On the CPU the same step function runs eagerly;
  * **paged KV on the lattice** — state leaves carry a slot axis and a
    capacity axis of ``pages x MXNET_DECODE_PAGE_TOKENS`` tokens; a
    sequence growing past a page boundary moves to the neighbouring key
    (its live rows copied across, compacted to the low slots);
  * **KV pages are an evictable memory resource**, tagged
    ``serve_kv_pages`` in the memory ledger: growth asks
    ``memory.ensure_headroom`` first, and ``release_kv_pages`` (the
    registry's first reclaim phase, through ``reclaim_kv_pages``) fails the
    coldest sequences typed (``SequenceEvicted`` with ``retry_after_s``)
    and frees real bytes;
  * **EDF shedding at decode-step granularity** (``resilience.StepEDF``):
    admission sheds a sequence whose deadline the remaining-tokens x
    step-EWMA estimate cannot meet; between steps passed deadlines expire,
    and when admitted work waits, actives whose deadlines became
    unmeetable are preempted — typed ``DeadlineExceeded``.

The KV memory on the card: a CUDA graph reads and writes its tensors at
the addresses it was captured on, so each key's graph owns the state
buffers of that key.  ``warmup()`` captures the whole lattice, which
holds the sum of every key's state (at 64 slots, 64 pages of 16 tokens
and a 1024-wide float32 ``ToyLM``: 1.06 GB against the largest key's
256 MiB), and a step's transition copies the live rows between two
keys' buffers.  ``release_kv_pages`` frees the buffers and the graphs of
the keys other than the current one, largest first, until the deficit is
met (and all of them when no sequence is left); a key used again later
is captured again, counted as a readmission.  One buffer at the largest
key with every graph on views of it would cost only that key and make
growth free, but could never give memory back.  On the CPU only the
current key's state exists, as in the JAX package.

``ToyLM`` (self-contained) and ``CellModel`` (a steppable ``mx.rnn`` cell's
one-step Symbol run as a ``GraphPlan`` inside the step, so inside the same
CUDA graph) plug into the engine's model protocol;
``BucketingModule.generate`` routes here.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
import weakref
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as _np
import torch

from ..analysis import sanitizer as _san
from ..base import MXNetError, getenv
from ..context import as_device, current_context
from ..faultinject import fire as _fi_fire
from ..observability import flight as _flight
from ..observability import goodput as _goodput
from ..observability import introspect as _introspect
from ..observability import memory as _memory
from ..observability import metrics as _metrics
from .batcher import GenerativeRouteError
from .buckets import bucket_label, page_lattice
from .resilience import DeadlineExceeded, Overloaded, StepEDF

log = logging.getLogger(__name__)

__all__ = ["DecodeEngine", "ToyLM", "CellModel", "SequenceEvicted",
           "DecodeClosedError", "GenerativeRouteError", "reclaim_kv_pages",
           "live_engines"]

#: ledger tag of paged decode state: the cheapest victims of the
#: multi-model registry (a shed sequence retries; weights must re-upload)
KV_TAG = "serve_kv_pages"


class SequenceEvicted(Overloaded):
    """This sequence's KV pages were reclaimed under memory pressure;
    ``retry_after_s`` estimates when decode capacity frees — resubmit the
    prompt."""


class DecodeClosedError(MXNetError):
    """The engine was closed before this sequence finished (or before it
    could be submitted)."""


class _Seq:
    __slots__ = ("sid", "prompt", "max_new", "deadline", "priority",
                 "tenant", "future", "generated", "pos", "slot", "t0",
                 "trace_id", "eos")

    def __init__(self, sid: int, prompt, max_new: int,
                 deadline: Optional[float], priority: int, tenant: str,
                 eos: Optional[int]):
        self.sid = sid
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.deadline = deadline  # absolute perf_counter time, or None
        self.priority = int(priority)
        self.tenant = str(tenant)
        self.future: Future = Future()
        self.generated: List[int] = []
        self.pos = 0          # next position to be written
        self.slot: Optional[int] = None
        self.t0 = time.perf_counter()
        self.trace_id = _flight.new_trace_id() if _flight.ENABLED else None
        self.eos = eos

    def remaining(self) -> int:
        """Decode steps left: unconsumed prompt + ungenerated tokens."""
        return max(0, len(self.prompt) - 1 - self.pos) \
            + max(0, self.max_new - len(self.generated))


_engines_lock = _san.make_lock("serving.decode.engines")
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def live_engines() -> list:
    with _engines_lock:
        return list(_ENGINES)


def reclaim_kv_pages(deficit: float, why: str = "") -> float:
    """Ask every live engine to shed its coldest sequences' pages until
    ~``deficit`` bytes are freed (the registry's first reclaim phase).
    Returns the bytes freed."""
    freed = 0.0
    for eng in live_engines():
        if freed >= deficit:
            break
        try:
            freed += eng.release_kv_pages(deficit - freed, why=why)
        except Exception as e:  # noqa: BLE001 — reclaim is best-effort
            log.warning("decode KV reclaim on %r failed (%s): %s",
                        getattr(eng, "name", "?"), why, str(e))
    return freed


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
class ToyLM:
    """Self-contained decode model: embedding -> tanh recurrence ->
    sliding-window attention over the paged KV log -> vocab projection,
    greedy argmax.  Row ``i`` of every op reads only row ``i`` of the
    state and tokens (slot independence), and the KV read is a fixed
    ``window`` of positions ``<= pos`` with invalid lanes masked to exact
    zeros (capacity independence), as in the JAX package's ``ToyLM``; the
    KV write is in place."""

    def __init__(self, vocab: int = 32, dim: int = 16, window: int = 8):
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.window = int(window)
        if min(self.vocab, self.dim, self.window) < 1:
            raise MXNetError("ToyLM needs vocab/dim/window >= 1")

    #: state leaves with a pages-backed capacity axis (axis index)
    state_capacity_axes = {"kv": 1}

    def init_params(self, seed: int = 0) -> Dict[str, _np.ndarray]:
        """The JAX package's draws, in its order."""
        rng = _np.random.RandomState(seed)
        s = 0.2
        return {
            "emb": rng.uniform(-s, s, (self.vocab, self.dim))
            .astype(_np.float32),
            "wx": rng.uniform(-s, s, (self.dim, self.dim))
            .astype(_np.float32),
            "wh": rng.uniform(-s, s, (self.dim, self.dim))
            .astype(_np.float32),
            "out": rng.uniform(-s, s, (self.dim, self.vocab))
            .astype(_np.float32),
        }

    def state_shapes(self, slots: int, capacity: int) -> Dict[str, tuple]:
        return {"h": ((slots, self.dim), _np.float32),
                "kv": ((slots, capacity, self.dim), _np.float32)}

    def step(self, params, state, tokens, pos):
        x = params["emb"][tokens]                              # (S, D)
        h = torch.tanh(x @ params["wx"] + state["h"] @ params["wh"])
        kv = state["kv"]
        slots, cap, dim = kv.shape
        rows = torch.arange(slots, device=kv.device)
        col = pos.clamp(0, cap - 1)
        # a position past the capacity writes nothing (the JAX where)
        kv[rows, col] = torch.where((pos < cap)[:, None], h, kv[rows, col])
        offs = torch.arange(self.window, device=kv.device)
        idx = pos[:, None] - offs[None, :]                     # (S, W)
        valid = (idx >= 0).to(kv.dtype)
        got = torch.gather(
            kv, 1, idx.clamp(0, cap - 1)[..., None].expand(
                slots, self.window, dim))                      # (S, W, D)
        r = (got * valid[..., None]).sum(dim=1) \
            / valid.sum(dim=1, keepdim=True)
        logits = (h + r) @ params["out"]                       # (S, V)
        return logits, {"h": h, "kv": kv}


class CellModel:
    """A *steppable* ``rnn.BaseRNNCell`` as a decode model: the cell's
    one-step Symbol (``cell(x, states)``) becomes a ``GraphPlan`` run inside
    the engine's step (on the card, inside its CUDA graph), between a token
    embedding and a vocab projection, with a paged KV log of the cell's
    outputs.  This is how ``rnn/`` and ``BucketingModule`` generation route
    through continuous batching.  The weights are the JAX package's draws:
    uniform(±0.2) in its order, biases zero.

    Non-steppable cells (``FusedRNNCell``, ``BidirectionalCell``) are
    refused with a typed ``GenerativeRouteError``: ``unfuse()`` a fused
    stack first."""

    def __init__(self, cell, vocab: int, seed: int = 0):
        if not getattr(cell, "steppable", False):
            raise GenerativeRouteError(
                f"{type(cell).__name__} cannot emit a one-token decode "
                f"step (fused/bidirectional cells consume whole "
                f"sequences): unfuse() it, or build the engine on a "
                f"steppable cell")
        from .. import symbol as _symbol
        from ..symbol.graph import GraphPlan
        self.vocab = int(vocab)
        self._infos = list(cell.state_info)
        x = _symbol.Variable("decode_x")
        states = [_symbol.Variable(f"decode_state{i}")
                  for i in range(len(self._infos))]
        out, new_states = cell(x, states)
        self._plan = GraphPlan(_symbol.Group([out] + list(new_states)))
        self._state_names = [f"decode_state{i}"
                             for i in range(len(self._infos))]
        # one-step shape inference at batch 1 sizes every cell parameter
        # and the cell's output width (the KV log's and the projection's)
        self.dim = int(self._infos[0]["shape"][-1])
        known = {"decode_x": (1, self.dim)}
        for n, info in zip(self._state_names, self._infos):
            known[n] = (1,) + tuple(info["shape"][1:])
        arg_shapes, out_shapes, _aux = self._plan.symbol.infer_shape(**known)
        self._arg_shapes = dict(zip(self._plan.symbol.list_arguments(),
                                    arg_shapes))
        self.out_dim = int(out_shapes[0][-1])
        self._seed = int(seed)

    @property
    def state_capacity_axes(self):
        return {"kv": 1}

    def init_params(self, seed: Optional[int] = None):
        rng = _np.random.RandomState(self._seed if seed is None else seed)
        s = 0.2
        params = {
            "decode_emb": rng.uniform(-s, s, (self.vocab, self.dim))
            .astype(_np.float32),
            "decode_out": rng.uniform(-s, s, (self.out_dim, self.vocab))
            .astype(_np.float32),
        }
        skip = {"decode_x"} | set(self._state_names)
        for name, shp in self._arg_shapes.items():
            if name in skip:
                continue
            if name.endswith("_bias"):
                params[name] = _np.zeros(shp, dtype=_np.float32)
            else:
                params[name] = rng.uniform(-s, s, shp).astype(_np.float32)
        return params

    def state_shapes(self, slots: int, capacity: int) -> Dict[str, tuple]:
        out = {"kv": ((slots, capacity, self.out_dim), _np.float32)}
        for n, info in zip(self._state_names, self._infos):
            out[n] = ((slots,) + tuple(info["shape"][1:]), _np.float32)
        return out

    def step(self, params, state, tokens, pos):
        x = params["decode_emb"][tokens]                       # (S, D)
        args = {n: v for n, v in params.items()
                if n not in ("decode_emb", "decode_out")}
        args["decode_x"] = x
        for n in self._state_names:
            args[n] = state[n]
        outs, _aux = self._plan.run(args, {}, is_train=False)
        cell_out, new_states = outs[0], outs[1:]
        kv = state["kv"]
        slots, cap, _ = kv.shape
        rows = torch.arange(slots, device=kv.device)
        col = pos.clamp(0, cap - 1)
        # a position past the capacity writes nothing (the JAX where)
        kv[rows, col] = torch.where((pos < cap)[:, None], cell_out,
                                    kv[rows, col])
        logits = cell_out @ params["decode_out"]
        new_state = {"kv": kv}
        for n, ns in zip(self._state_names, new_states):
            new_state[n] = ns
        return logits, new_state


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class DecodeEngine:
    """Continuous-batching decode server over one model.

    Parameters
    ----------
    model
        The decode-model protocol: ``init_params(seed)``,
        ``state_shapes(slots, capacity) -> {name: (shape, dtype)}`` (every
        leaf slot-major; pages-backed leaves in ``state_capacity_axes``)
        and ``step(params, state, tokens, pos) -> (logits, new_state)``
        with row ``i`` depending only on slot ``i``; ``step`` may write
        the state in place and return it.
    params : dict, optional
        Host parameter arrays (default ``model.init_params()``), uploaded
        once and tagged ``serve_weights``.
    slots / page_tokens / max_pages : int, optional
        At most ``slots`` concurrent sequences (``MXNET_DECODE_SLOTS``,
        8), KV in pages of ``MXNET_DECODE_PAGE_TOKENS`` tokens (16), up to
        ``MXNET_DECODE_MAX_PAGES`` pages (8) a sequence.
    max_queue : int, optional
        Bound on waiting sequences (``MXNET_SERVE_MAX_QUEUE``).
    shed_policy : str, optional
        ``"deadline"`` (default, ``MXNET_SERVE_SHED_POLICY``) or
        ``"depth"``.
    dev : Context, optional
        Where the weights and the state live (default: the current
        context, ``gpu(0)``; without a CUDA device that raises).
    """

    def __init__(self, model, params: Optional[dict] = None,
                 slots: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 max_pages: Optional[int] = None,
                 slot_buckets=None, page_buckets=None,
                 max_queue: Optional[int] = None,
                 shed_policy: Optional[str] = None,
                 eos: Optional[int] = None,
                 name: str = "decode", warmup: bool = True, dev=None):
        self.model = model
        self.name = str(name)
        self._ctx = dev if dev is not None else current_context()
        self._device = as_device(self._ctx)   # raises: gpu without CUDA
        self._cuda = self._device.type == "cuda"
        self.max_slots = int(getenv("MXNET_DECODE_SLOTS", 8)) \
            if slots is None else int(slots)
        self.page_tokens = int(getenv("MXNET_DECODE_PAGE_TOKENS", 16)) \
            if page_tokens is None else int(page_tokens)
        self.max_pages = int(getenv("MXNET_DECODE_MAX_PAGES", 8)) \
            if max_pages is None else int(max_pages)
        if min(self.max_slots, self.page_tokens, self.max_pages) < 1:
            raise MXNetError("DecodeEngine needs slots/page_tokens/"
                             "max_pages >= 1")
        self.max_queue = int(getenv("MXNET_SERVE_MAX_QUEUE", 64)) \
            if max_queue is None else int(max_queue)
        policy = shed_policy or getenv("MXNET_SERVE_SHED_POLICY",
                                       "deadline")
        if policy not in ("depth", "deadline"):
            raise MXNetError(f"shed_policy must be 'depth' or "
                             f"'deadline', got {policy!r}")
        self.shed_policy = policy
        self.eos = eos
        self.spec = page_lattice(self.max_slots, self.max_pages,
                                 slot_buckets=slot_buckets,
                                 page_buckets=page_buckets)
        self.capacity = self.page_tokens * self.max_pages
        # reentrant: step() -> KV growth -> ensure_headroom -> arbiter ->
        # release_kv_pages re-enters on the same thread
        self._lock = _san.make_rlock("serving.decode.engine")
        self._closed = False
        self._seq_no = 0
        self._waiting: List[_Seq] = []
        self._slots: List[Optional[_Seq]] = []
        self._key: Optional[tuple] = None
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._edf = StepEDF()
        self._steps = 0
        self._replays = 0
        self._admitted = 0
        self._completed = 0
        self._evicted = 0
        self._shed = 0
        self._expired = 0
        self._tokens_out = 0
        #: keys built: on the card {key: {"state", "io", "graph", "nxt"}}
        self._compiled: Dict[tuple, dict] = {}
        self._ever_compiled: set = set()
        self._pool = None

        host = dict(params) if params is not None else model.init_params()
        pbytes = sum(int(_np.asarray(v).nbytes) for v in host.values())
        # ask first: the budget arbiter may evict colder victims
        _memory.ensure_headroom(pbytes, why=f"decode.admit:{self.name}")
        self._params = {
            k: _memory.register(torch.as_tensor(_np.asarray(v)).to(
                self._device), tag="serve_weights")
            for k, v in host.items()}
        with _engines_lock:
            _ENGINES.add(self)
        if warmup:
            self.warmup()

    # -- the step function ---------------------------------------------------
    def _step_fn(self, state, io):
        """One decode step over ``state`` (written in place): ``io`` rows
        are tokens, positions and "fresh" (never dispatched: the slot's
        rows may be a retired predecessor's, zeroed here).  Returns the
        next tokens."""
        tokens, pos, fresh = io[0], io[1], io[2].bool()
        for leaf in state.values():
            leaf.masked_fill_(fresh.view((-1,) + (1,) * (leaf.dim() - 1)),
                              0)
        logits, new_state = self.model.step(self._params, state, tokens,
                                            pos)
        for n, t in new_state.items():
            if t is not state[n]:
                state[n].copy_(t)
        return torch.argmax(logits, dim=-1)

    def _state_shapes(self, key: tuple) -> Dict[str, tuple]:
        slots_b, pages_b = key
        return self.model.state_shapes(slots_b,
                                       pages_b * self.page_tokens)

    def _state_bytes(self, key: tuple) -> int:
        return sum(int(_np.prod(shp)) * _np.dtype(dt).itemsize
                   for shp, dt in self._state_shapes(key).values())

    def _new_state(self, key: tuple) -> Dict[str, torch.Tensor]:
        return {n: _memory.register(
                    torch.zeros(shp, dtype=getattr(torch, _np.dtype(dt).name),
                                device=self._device), tag=KV_TAG)
                for n, (shp, dt) in self._state_shapes(key).items()}

    def _count(self, key: tuple) -> None:
        """The introspector's ``decode_step:<key>`` program, counted on
        meta tensors (nothing runs)."""
        if not _introspect.ENABLED:
            return
        try:
            meta = {n: torch.empty(shp, dtype=getattr(
                        torch, _np.dtype(dt).name), device="meta")
                    for n, (shp, dt) in self._state_shapes(key).items()}
            io = torch.zeros((3, key[0]), dtype=torch.int64, device="meta")
            params = self._params
            self._params = {k: torch.empty_like(v, device="meta")
                            for k, v in params.items()}
            try:
                with _introspect.counting("decode_step",
                                          label=bucket_label(key)):
                    self._step_fn(meta, io)
            finally:
                self._params = params
        except Exception as e:  # noqa: BLE001 — stats are best-effort
            log.debug("decode_step counting failed: %s", str(e))

    def precompile(self, key: tuple):
        """Build one (slots, pages) key: on the card, its state buffers,
        its static input and output and its CUDA graph (captured after one
        eager run on a side stream); on the CPU nothing is built.  A first
        build counts in ``SERVE_COMPILES``, a rebuild of a key whose
        buffers were reclaimed as a readmission; after ``warmup()`` traffic
        builds nothing."""
        key = tuple(key)
        with self._lock:
            ent = self._compiled.get(key)
            if ent is not None:
                return ent
            t0 = time.perf_counter()
            ent = {}
            if self._cuda:
                ent = self._capture(key)
            if _goodput.ENABLED:
                _goodput.attribute("recompile", time.perf_counter() - t0)
            if _metrics.ENABLED:
                if key in self._ever_compiled:
                    _metrics.SERVE_READMITS.inc(kind="bucket")
                else:
                    _metrics.SERVE_COMPILES.inc()
            if key not in self._ever_compiled:
                self._count(key)
            self._ever_compiled.add(key)
            self._compiled[key] = ent
            return ent

    def _capture(self, key: tuple) -> dict:
        state = self._new_state(key)
        io = torch.zeros((3, key[0]), dtype=torch.int64, device=self._device)
        with torch.cuda.device(self._device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._step_fn(state, io)     # loads every kernel first
            cur.wait_stream(side)
            g = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(g, pool=self._pool):
                    nxt = self._step_fn(state, io)
            except Exception as e:  # noqa: BLE001 — name the stage
                raise MXNetError(
                    f"decode engine {self.name!r}: capturing the decode "
                    f"step of key {key} into a CUDA graph failed: "
                    f"{type(e).__name__}: {e}") from e
        return {"state": state, "io": io, "graph": g, "nxt": nxt}

    def warmup(self, keys=None) -> int:
        """Build the whole lattice before traffic: afterwards join, leave
        and page growth route between built keys, with no capture."""
        done = 0
        for key in (keys if keys is not None else self.spec.all_keys()):
            self.precompile(tuple(key))
            done += 1
        return done

    # -- admission -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               deadline_ms: Optional[float] = None, priority: int = 0,
               tenant: str = "default") -> Future:
        """Admit one sequence; resolves to its generated token list.
        Sheds typed (``Overloaded`` with retry-after) on a full waiting
        queue or, policy ``deadline``, when the EDF estimate cannot meet
        ``deadline_ms``; an over-capacity request raises."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("decode submit needs a non-empty prompt")
        total = len(prompt) + int(max_new_tokens)
        if total > self.capacity:
            raise MXNetError(
                f"sequence needs {total} tokens > engine capacity "
                f"{self.capacity} (MXNET_DECODE_PAGE_TOKENS x "
                f"MXNET_DECODE_MAX_PAGES)")
        with self._lock:
            if self._closed:
                raise DecodeClosedError("DecodeEngine is closed")
            deadline = None if deadline_ms is None \
                else time.perf_counter() + float(deadline_ms) / 1e3
            seq = _Seq(self._seq_no, prompt, max_new_tokens, deadline,
                       priority, tenant, self.eos)
            self._seq_no += 1
            if len(self._waiting) >= self.max_queue:
                self._count_shed(tenant, "queue_full")
                retry = self._edf.eta_s(self._queued_tokens(),
                                        self._free_slots() or 1)
                raise Overloaded(
                    f"decode waiting queue full ({self.max_queue}, "
                    f"MXNET_SERVE_MAX_QUEUE); retry after "
                    f"~{retry:.2f}s", retry_after_s=retry)
            if self.shed_policy == "deadline" and deadline is not None:
                eta = self._edf.eta_s(
                    seq.remaining() + self._queued_tokens(),
                    max(1, self.max_slots))
                if time.perf_counter() + eta > deadline:
                    self._count_shed(tenant, "deadline_unmeetable")
                    raise Overloaded(
                        f"deadline {deadline_ms}ms unmeetable: EDF "
                        f"estimate ~{eta * 1e3:.1f}ms for "
                        f"{seq.remaining()} decode steps behind "
                        f"{self._queued_tokens()} queued tokens",
                        retry_after_s=eta)
            self._admitted += 1
            if _metrics.ENABLED:
                _metrics.SERVE_ADMITTED.inc(tenant=tenant)
            self._waiting.append(seq)
            # EDF order: priority first, earliest deadline within it
            self._waiting.sort(key=lambda s: (
                -s.priority,
                s.deadline if s.deadline is not None else float("inf"),
                s.sid))
            return seq.future

    def generate(self, prompt, max_new_tokens: int, **kw) -> List[int]:
        """Submit and drive the engine until this sequence resolves."""
        fut = self.submit(prompt, max_new_tokens, **kw)
        while not fut.done():
            if self.step() == 0 and not fut.done():
                break
        return fut.result()

    def _count_shed(self, tenant: str, reason: str) -> None:
        self._shed += 1
        if _metrics.ENABLED:
            _metrics.SERVE_SHED.inc(tenant=tenant, reason=reason)

    def _queued_tokens(self) -> int:
        return sum(s.remaining() for s in self._waiting)

    def _free_slots(self) -> int:
        return self.max_slots - sum(1 for s in self._slots
                                    if s is not None)

    # -- the decode step -----------------------------------------------------
    def _retire(self, seq: _Seq, exc: Optional[Exception] = None) -> None:
        """Free the sequence's slot and resolve its future (the caller
        holds the lock)."""
        if seq.slot is not None and seq.slot < len(self._slots) \
                and self._slots[seq.slot] is seq:
            self._slots[seq.slot] = None
        seq.slot = None
        if seq.future.done():
            return
        if exc is not None:
            seq.future.set_exception(exc)
            return
        self._completed += 1
        seq.future.set_result(list(seq.generated))
        if _goodput.ENABLED:
            _goodput.serve_latency_sample(
                (time.perf_counter() - seq.t0) * 1e3)
        if _flight.ENABLED:
            _flight.record("decode_seq", "serving", seq.t0 * 1e6,
                           _flight.now_us(), trace_id=seq.trace_id)

    def _shed_and_expire(self, now: float) -> None:
        """Expire passed deadlines; when admitted work waits, preempt
        actives whose deadlines the remaining-tokens estimate cannot
        meet."""
        for seq in [s for s in self._slots if s is not None]:
            if seq.deadline is None:
                continue
            if now > seq.deadline:
                self._expired += 1
                if _metrics.ENABLED:
                    _metrics.SERVE_EXPIRED.inc(tenant=seq.tenant)
                self._retire(seq, DeadlineExceeded(
                    f"sequence {seq.sid} deadline passed after "
                    f"{len(seq.generated)} generated token(s)"))
            elif self.shed_policy == "deadline" and self._waiting \
                    and self._edf.unmeetable(seq.deadline, now,
                                             seq.remaining()):
                self._count_shed(seq.tenant, "deadline_unmeetable")
                self._retire(seq, DeadlineExceeded(
                    f"sequence {seq.sid} preempted at decode-step "
                    f"granularity: {seq.remaining()} steps x "
                    f"~{self._edf.step_s() * 1e3:.1f}ms cannot meet "
                    f"its deadline and admitted work is waiting"))
        for seq in [s for s in self._waiting
                    if s.deadline is not None and now > s.deadline]:
            self._waiting.remove(seq)
            self._expired += 1
            if _metrics.ENABLED:
                _metrics.SERVE_EXPIRED.inc(tenant=seq.tenant)
            if not seq.future.done():
                seq.future.set_exception(DeadlineExceeded(
                    f"sequence {seq.sid} deadline passed in queue"))

    def _admit_waiting(self) -> None:
        """Fill free slots in EDF order (the caller holds the lock)."""
        if not self._waiting:
            return
        if len(self._slots) < self.max_slots:
            self._slots.extend(
                [None] * (self.max_slots - len(self._slots)))
        for i in range(self.max_slots):
            if not self._waiting:
                break
            if self._slots[i] is None:
                seq = self._waiting.pop(0)
                seq.slot = i
                self._slots[i] = seq

    def _needed_key(self, compact: bool = False) -> Optional[tuple]:
        """Smallest lattice key covering the in-flight set: on the highest
        occupied slot, or (``compact``) on the live count a compaction
        would leave."""
        hi = -1
        live = 0
        max_pos = 0
        for i, s in enumerate(self._slots):
            if s is not None:
                hi = i
                live += 1
                max_pos = max(max_pos, s.pos + 1)
        if hi < 0:
            return None
        pages = -(-max_pos // self.page_tokens)  # ceil
        slots_need = live if compact else hi + 1
        return self.spec.route({"kv": (slots_need, pages)})

    def _held_bytes(self) -> int:
        """Device bytes of decode state held now: the current key's on the
        CPU, every built key's on the card."""
        if self._cuda:
            return sum(self._state_bytes(k) for k, e in
                       self._compiled.items() if e)
        return self._state_bytes(self._key) \
            if self._state is not None else 0

    def _growth(self, key: tuple) -> int:
        if self._cuda:
            return 0 if self._compiled.get(key) else self._state_bytes(key)
        return self._state_bytes(key) - self._held_bytes()

    def _transition(self, new_key: tuple) -> None:
        """Move the live rows onto ``new_key``'s state: occupied slots
        compact to the low indices, the capacity axis keeps its low side,
        the rest is zeros.  Growth asks the budget first; on refusal the
        longest actives are evicted typed until the rest fits."""
        grow = self._growth(new_key)
        if grow > 0 and not _memory.ensure_headroom(
                grow, why=f"decode.kv_grow:{self.name}"):
            self._evict_for_fit()
            new_key = self._needed_key(compact=True)
            if new_key is None:
                self._drop_state()
                return
        live = [s for s in self._slots if s is not None]
        if self._cuda:
            new_state = self.precompile(new_key)["state"]
            if new_state is self._state:
                return
        else:
            new_state = self._new_state(new_key)
        with torch.no_grad():
            if self._cuda:
                for t in new_state.values():
                    t.zero_()
            if self._state is not None and live:
                # a slot joined since the last step lies past the old
                # key's rows: it is fresh, and the step zeroes its rows
                old_slots = self._key[0]
                perm = torch.tensor([min(s.slot, old_slots - 1)
                                     for s in live],
                                    dtype=torch.int64, device=self._device)
                for n, leaf in self._state.items():
                    dst = new_state[n]
                    sl = tuple(slice(0, min(a, b)) for a, b in
                               zip(leaf.shape[1:], dst.shape[1:]))
                    dst[(slice(0, len(live)),) + sl] = \
                        leaf.index_select(0, perm)[(slice(None),) + sl]
        self._state = new_state
        for i, s in enumerate(live):
            s.slot = i
        self._slots = live + [None] * (self.max_slots - len(live))
        self._key = new_key

    def _drop_state(self) -> None:
        """No live sequence: on the CPU the state is freed; on the card
        the built keys' buffers stay (their graphs read them) until
        ``release_kv_pages`` frees them."""
        self._state = None
        self._key = None

    def _free_keys(self, deficit: float, keep: Optional[tuple]) -> float:
        """On the card: free the buffers and graphs of built keys other
        than ``keep``, largest first, until ``deficit`` bytes are freed."""
        freed = 0.0
        keys = sorted((k for k, e in self._compiled.items()
                       if e and k != keep),
                      key=lambda k: -self._state_bytes(k))
        for k in keys:
            if freed >= deficit:
                break
            freed += self._state_bytes(k)
            del self._compiled[k]
        if not self._compiled:
            self._pool = None
        return freed

    def _evict_for_fit(self) -> None:
        victims = sorted((s for s in self._slots if s is not None),
                         key=lambda s: -s.pos)
        for seq in victims:
            need = self._needed_key(compact=True)
            if need is None or self._growth(need) <= 0:
                return
            self._evict_seq(seq, why="kv_grow")

    def _evict_seq(self, seq: _Seq, why: str) -> None:
        self._evicted += 1
        if _metrics.ENABLED:
            _metrics.SERVE_EVICTIONS.inc(kind="kv_pages", model=self.name)
            _metrics.DECODE_KV_EVICTIONS.inc()
        retry = self._edf.eta_s(self._queued_tokens() + seq.remaining(),
                                max(1, self.max_slots))
        self._retire(seq, SequenceEvicted(
            f"sequence {seq.sid} KV pages reclaimed under memory "
            f"pressure ({why}); resubmit after ~{retry:.2f}s",
            retry_after_s=max(0.05, retry)))

    def release_kv_pages(self, deficit: float, why: str = "") -> float:
        """Reclaim ~``deficit`` bytes of decode state (the registry's
        first reclaim phase).  Victims are the actives with the lowest
        priority, latest deadline and most work left; each fails typed
        with a retry-after.  The survivors move onto the smaller key, and
        the freed buffers are dropped, so the bytes are real.  A busy
        engine (another thread mid-step) returns 0 instead of blocking."""
        if not self._lock.acquire(blocking=False):
            return 0.0
        try:
            before = self._held_bytes()
            if before == 0 or (self._state is None and not self._cuda):
                return 0.0
            with _flight.phase_span("serve_evict", cat="serving",
                                    mem=True, labels={"model": self.name}):
                _fi_fire("serving.evict", model=self.name,
                         kind="kv_pages", why=why)
                victims = sorted(
                    (s for s in self._slots if s is not None),
                    key=lambda s: (
                        s.priority,
                        -(s.deadline if s.deadline is not None
                          else float("inf")),
                        -s.remaining()))
                for seq in victims:
                    if self._reclaimable(before) >= deficit:
                        break
                    self._evict_seq(seq, why=why or "arbiter")
                    need = self._needed_key(compact=True)
                    if need is None:
                        self._drop_state()
                    elif need != self._key:
                        self._transition(need)
                if self._cuda:
                    self._free_keys(deficit - (before - self._held_bytes()),
                                    keep=self._key)
            return float(before - self._held_bytes())
        finally:
            self._lock.release()

    def _reclaimable(self, before: int) -> float:
        """Bytes freed so far, plus (on the card) what freeing the keys
        other than the current one would give."""
        if not self._cuda:
            return before - self._held_bytes()
        keep = self._state_bytes(self._key) if self._key else 0
        return before - keep

    def step(self) -> int:
        """ONE decode step over the whole in-flight set: expire and shed
        (EDF), admit waiters into free slots, route the lattice key, then
        one replay (the eager step on the CPU).  Returns the number of
        active sequences advanced (0: idle)."""
        with self._lock:
            if self._closed:
                raise DecodeClosedError("DecodeEngine is closed")
            now = time.perf_counter()
            self._shed_and_expire(now)
            self._admit_waiting()
            key = self._needed_key()
            if key is None:
                if self._state is not None:
                    self._drop_state()
                self._refresh_gauges()
                return 0
            if key != self._key or self._state is None:
                self._transition(key)
                key = self._key
                if key is None:
                    self._refresh_gauges()
                    return 0
            ent = self.precompile(key)
            slots_b = key[0]
            io = _np.zeros((3, slots_b), dtype=_np.int64)
            active = []
            for i in range(slots_b):
                s = self._slots[i]
                if s is None:
                    continue
                active.append(s)
                io[0, i] = s.prompt[s.pos] if s.pos < len(s.prompt) \
                    else s.generated[-1]
                io[1, i] = s.pos
                io[2, i] = s.pos == 0
            t0 = time.perf_counter()
            with _flight.phase_span("decode_step", cat="serving", mem=True,
                                    labels={"bucket": bucket_label(key)}), \
                    _memory.oom_guard("serving.decode_step"):
                # before the replay: a raise leaves every sequence intact,
                # so a retried step() resumes bitwise
                _fi_fire("serving.decode_step", step=self._steps,
                         active=len(active))
                if _metrics.ENABLED:
                    _metrics.DECODE_STEPS.inc()
                try:
                    with _metrics.dispatch_unit("decode"):
                        nxt = self._run(ent, io)
                except BaseException as e:
                    self._drop_state()
                    err = MXNetError(
                        f"decode step failed mid-generation: "
                        f"{type(e).__name__}: {e}")
                    for s in active:
                        self._retire(s, err)
                    raise
            self._steps += 1
            step_s = time.perf_counter() - t0
            self._edf.observe(step_s)
            gen = 0
            for s in active:
                emitting = s.pos >= len(s.prompt) - 1
                s.pos += 1
                if emitting:
                    tok = int(nxt[s.slot])
                    s.generated.append(tok)
                    gen += 1
                    done = len(s.generated) >= s.max_new or (
                        s.eos is not None and tok == s.eos)
                    if done:
                        self._retire(s)
            self._tokens_out += gen
            if _metrics.ENABLED:
                if gen:
                    _metrics.DECODE_TOKENS.inc(gen)
                if step_s > 0:
                    _metrics.DECODE_TOKENS_PER_S.set(
                        len(active) / max(step_s, 1e-9))
            self._refresh_gauges()
            if _flight.ENABLED:
                _flight.note("decode_step", step_s)
            return len(active)

    def _run(self, ent: dict, io: _np.ndarray) -> _np.ndarray:
        """The step on the card (copy the inputs into the key's static
        tensor, replay, read the next tokens back once) or on the CPU."""
        host = torch.from_numpy(io)
        if not self._cuda:
            with torch.no_grad():
                return self._step_fn(self._state, host).numpy()
        with torch.cuda.device(self._device):
            ent["io"].copy_(host)
            _metrics.note_h2d()
            ent["graph"].replay()
            self._replays += 1
            return ent["nxt"].cpu().numpy()

    def drain(self, max_steps: int = 100000) -> int:
        """Step until idle; returns the steps run."""
        n = 0
        while n < max_steps:
            if self.step() == 0:
                break
            n += 1
        return n

    def _refresh_gauges(self) -> None:
        if not _metrics.ENABLED:
            return
        inflight = sum(1 for s in self._slots if s is not None)
        _metrics.DECODE_INFLIGHT.set(float(inflight))
        if self._key is not None and self._state is not None:
            slots_b, pages_b = self._key
            cap = slots_b * pages_b * self.page_tokens
            used = sum(s.pos + 1 for s in self._slots if s is not None)
            _metrics.DECODE_KV_OCCUPANCY.set(used / cap if cap else 0.0)
        else:
            _metrics.DECODE_KV_OCCUPANCY.set(0.0)

    # -- introspection / lifecycle -------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return len(self._waiting) + sum(
                1 for s in self._slots if s is not None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "steps": self._steps,
                "replays": self._replays,
                "tokens": self._tokens_out,
                "admitted": self._admitted,
                "completed": self._completed,
                "evicted": self._evicted,
                "shed": self._shed,
                "expired": self._expired,
                "inflight": sum(1 for s in self._slots if s is not None),
                "waiting": len(self._waiting),
                "key": self._key,
                "kv_bytes": self._held_bytes(),
                "keys_built": len([e for e in self._compiled.values()
                                   if e]) if self._cuda
                else len(self._compiled),
                "step_ewma_s": self._edf.step_s(),
                "goodput": (self._completed / self._admitted)
                if self._admitted else 1.0,
            }

    def memory_stats(self) -> dict:
        with self._lock:
            return {
                "weights_bytes": sum(v.numel() * v.element_size()
                                     for v in self._params.values()),
                "kv_bytes": self._held_bytes(),
            }

    def close(self) -> None:
        """Fail everything in flight typed and drop the built keys, the
        weights and the KV state."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            err = DecodeClosedError(
                "DecodeEngine closed before this sequence finished")
            for s in list(self._waiting):
                if not s.future.done():
                    s.future.set_exception(err)
            self._waiting.clear()
            for s in list(self._slots):
                if s is not None:
                    self._retire(s, err)
            self._slots = []
            self._drop_state()
            self._compiled.clear()
            self._pool = None
            self._params = {}
            if _metrics.ENABLED:
                _metrics.DECODE_INFLIGHT.set(0.0)
                _metrics.DECODE_KV_OCCUPANCY.set(0.0)
        with _engines_lock:
            _ENGINES.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# python -m mxnet_tpu_torch.serving.decode --smoke [--cpu]
# ---------------------------------------------------------------------------
def _smoke(cpu: bool) -> int:
    """Mixed-length traffic with per-step join and leave over a warmed
    lattice: one dispatch (replay) per decode step, no build after
    warmup, every admitted sequence finished."""
    from ..context import cpu as _cpu
    model = ToyLM(vocab=32, dim=8, window=4)
    eng = DecodeEngine(model, slots=4, page_tokens=4, max_pages=4,
                       name="smoke", dev=_cpu() if cpu else None)
    try:
        compiles0 = _metrics.SERVE_COMPILES.value
        launches0 = _metrics.DISPATCHES.get(kind="decode")
        rng = _np.random.RandomState(0)
        futs = []
        pending = [([int(t) for t in rng.randint(0, 32, size=n)], m)
                   for n, m in [(2, 3), (5, 8), (1, 12), (3, 2),
                                (7, 5), (2, 9), (4, 4), (1, 6)]]
        steps = 0
        while pending or eng.pending():
            for _ in range(2):
                if pending:
                    p, m = pending.pop(0)
                    futs.append(eng.submit(p, m))
            if eng.step() > 0:
                steps += 1
        outs = [f.result(timeout=5) for f in futs]
        launches = _metrics.DISPATCHES.get(kind="decode") - launches0
        compiles = _metrics.SERVE_COMPILES.value - compiles0
        ok = (launches == steps and compiles == 0
              and all(len(o) > 0 for o in outs)
              and eng.stats()["completed"] == len(futs))
        print(json.dumps({
            "decode_smoke": bool(ok), "steps": steps,
            "dispatches": launches, "post_warmup_compiles": compiles,
            "sequences": len(outs), "tokens": sum(len(o) for o in outs),
        }))
        if not ok:
            print("decode-smoke FAILED: dispatches != steps, a build "
                  "after warmup, or an unfinished sequence",
                  file=sys.stderr)
            return 1
        return 0
    finally:
        eng.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mxnet_tpu_torch.serving.decode")
    ap.add_argument("--smoke", action="store_true",
                    help="run the decode smoke check")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of gpu(0)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.cpu)
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
