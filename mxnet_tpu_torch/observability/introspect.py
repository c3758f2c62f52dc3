"""Program introspection: flops and bytes per program, per-layer
attribution, MFU against the card's peak, and the persisted perf-regression
sentinel (parity: ``mxnet_tpu/observability/introspect.py``).

The JAX package reads XLA's ``cost_analysis()`` and parses the optimized
HLO.  The port has no HLO: it **counts** a program instead.  ``Count`` is a
``TorchDispatchMode`` that sees every aten op a program runs and books

  * matrix products and convolutions with the formulas
    ``torch.utils.flop_counter`` registers (2 flops per multiply-add);
  * every other op at one flop per output element, reductions at one per
    input element, and data movement (views, copies, casts, gathers,
    concatenation, creation) at zero, as the JAX parser's per-opcode model
    does (``_instr_flops``);
  * bytes as each op's inputs read plus its outputs written.  The ops are
    unfused, so this comes out above XLA's "bytes accessed", which counts a
    fused region once;
  * the hand-written kernels by their model flops (``note_kernel``), since a
    ctypes launch is invisible to the dispatcher: the flash forward
    4·B·H·Tq·Tk·D, its backward 8·B·H·Tq·Tk·D, with no causal halving and
    no recompute, and the inputs read and outputs written once.  With
    these a step counts the same matrix-product flops with the kernel as
    with the plain version's matrix products.

Each program is counted **once**, as the JAX package notes it once per
compile: ``whole_step`` and ``superstep`` at the first step of each
configuration (the eager step that precedes the CUDA graph's capture on the
card, and launches what the capture records), ``gluon:fwd``/``gluon:bwd``
(``CachedOp``), ``executor:fwd``/``executor:fwd_bwd``, ``fused_update``
(``FusedUpdater.update_all``) and each served bucket's build at the first
call of each signature.  A replay runs no Python and costs nothing; the
steady-state cost of a hook is one boolean test and, for the sentinel, one
counter increment.

Per-layer attribution: ``layer_scope(name)`` pushes a name that the
counting pass groups its flops by and, while a profiler runs, opens a
``torch.profiler.record_function`` range, so measured time shows under the
same names in a trace.  ``GraphPlan.run`` wraps each node in its name; the
whole step wraps its reduce and update in the literal scopes ``allreduce``
and ``optimizer``.  Backward ops run outside any forward scope: the pass
tags the autograd nodes a scope created, and attributes a backward op to
the tag of the node that runs it (JAX: ``transpose(jvp(dense0_fwd))``).

``MXNET_INTROSPECT_HLO=1`` keeps each program's counted op table (op,
shapes, flops, bytes, scope, kind, calls) as its ``hlo`` text;
``dump_hlo`` writes it and ``parse_hlo_flops`` reads it back.

MFU divides by **the card's step time**: ``StepGraph`` records a CUDA event
pair around each ``whole_step`` and ``superstep`` replay and the next step
reads the previous pair without waiting (``drain_device_times``); those
times feed an EWMA that ``mfu()``, ``per_layer`` and the sentinel read,
and goodput books them as ``compute`` in place of the host span (so does
a configuration's first, eager step, kept out of the EWMA).
The host span of the flight recorder, which times the replay call's
enqueue, stays the watchdogs' input.  On the CPU there are no device
events, and the flight recorder's EWMA of the same phase is used.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..base import MXNetError, atomic_write, getenv, unique_path
from ..analysis import sanitizer as _san

log = logging.getLogger(__name__)

__all__ = ["ENABLED", "enabled", "enable", "disable", "layer_scope",
           "known_scopes", "note_program", "note_jit", "programs",
           "per_layer", "attributed_pct", "step_flops", "mfu",
           "peak_flops", "phase_flops_map", "dump_hlo", "report",
           "snapshot_summary", "sentinel_tick", "refresh_baseline",
           "baseline_dir", "baseline_path", "sentinel_armed",
           "regression_active", "sentinel_state", "reset", "configure",
           "Count", "counting", "note_kernel", "uncounted",
           "parse_hlo_flops", "device_step_time", "drain_device_times"]

# -- the fast-path switch ----------------------------------------------------
ENABLED: bool = getenv("MXNET_INTROSPECT", True)
#: keep each program's counted op table as its ``hlo`` text
HLO: bool = getenv("MXNET_INTROSPECT_HLO", False)
#: size cap on a kept op table, in bytes of text
HLO_CAP_BYTES: int = 8 << 20
#: sentinel check cadence, in sentinel_tick() calls per phase
SENTINEL_EVERY: int = 25
#: regression trigger: warmed step time > factor x persisted baseline p50
REGRESSION_FACTOR: float = 1.5
#: minimum seconds between PERF_REGRESSION firings per phase (tests 0)
REGRESSION_MIN_S: float = 300.0

UNATTRIBUTED = "_unattributed"

PHASE_PROGRAM = {"whole_step": "whole_step", "trainer_step": "fused_update",
                 "superstep": "superstep"}
#: programs whose flops sum to one fused-path training step
FUSED_STEP_PROGRAMS = ("gluon:fwd", "gluon:bwd", "fused_update")
#: phases whose time covers a whole training step (the fused path's
#: "trainer_step" span times Trainer.step alone)
FULL_STEP_PHASES = frozenset({"whole_step", "superstep"})

_lock = _san.make_lock("introspect.programs")
_programs: Dict[str, dict] = {}
_scopes: set = set()
#: number of ``Count`` sessions open in the process: the hot paths (the
#: flash wrappers, ``GraphPlan.run``'s tagging) test it before anything else
COUNTING: int = 0
_tls = threading.local()
_SCOPE_KEY = "mxnet_scope"


def enabled() -> bool:
    return ENABLED


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


# -- layer scopes ------------------------------------------------------------
def _stack() -> list:
    s = getattr(_tls, "scopes", None)
    if s is None:
        s = _tls.scopes = []
    return s


class _Scope:
    """What ``layer_scope`` yields: ``tag(outputs)`` marks the autograd
    nodes made inside the scope with its name (only while a program is
    being counted) and returns the outputs unchanged."""
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def tag(self, outs):
        if COUNTING:
            tag_graph(outs, self.name)
        return outs


class _NoScope:
    __slots__ = ()

    @staticmethod
    def tag(outs):
        return outs


_NO_SCOPE = _NoScope()


@contextlib.contextmanager
def layer_scope(name: str):
    """Push ``name`` as the current layer: the counting pass books the ops
    that run inside under it, and a running ``torch.profiler`` shows the
    range.  Names come from a bounded set (graph node names, literals).
    One boolean test when introspection is off."""
    if not ENABLED:
        yield _NO_SCOPE
        return
    _scopes.add(name)
    sc = _Scope(name)
    st = _stack()
    st.append(name)
    rf = None
    if torch.autograd._profiler_enabled():
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
    try:
        yield sc
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)
        st.pop()


def known_scopes() -> frozenset:
    return frozenset(list(_scopes))


def tag_graph(outs, name: str) -> None:
    """Mark every autograd node reachable from ``outs`` that no scope has
    marked yet with ``name`` (the nodes this scope's ops made)."""
    flat, _ = tree_flatten(outs)
    todo = [t.grad_fn for t in flat
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None:
            continue
        md = node.metadata
        if _SCOPE_KEY in md:
            continue
        md[_SCOPE_KEY] = name
        todo.extend(n for n, _ in node.next_functions)


def _current_scope() -> Optional[str]:
    st = getattr(_tls, "scopes", None)
    if st:
        return st[-1]
    cur = getattr(torch._C, "_current_autograd_node", None)
    node = cur() if cur is not None else None
    if node is not None:
        return node.metadata.get(_SCOPE_KEY)
    return None


# -- the counting pass -------------------------------------------------------
def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


#: ops that move, view, cast or create data and compute nothing (XLA's
#: HloCostAnalysis costs the same opcodes 0)
_ZERO_FLOP_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "slice", "select", "squeeze",
    "unsqueeze", "as_strided", "alias", "detach", "clone", "copy", "copy_",
    "_to_copy", "to", "contiguous", "cat", "stack", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "index_select",
    "gather", "embedding", "index", "slice_backward", "select_backward",
    "constant_pad_nd", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_empty",
    "new_empty_strided", "new_zeros", "new_ones", "new_full", "fill_",
    "fill", "zero_", "arange", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "scalar_tensor", "resize_", "set_", "repeat",
    "flip", "roll", "unfold", "diagonal", "_foreach_copy_", "masked_select",
    "nonzero", "unsqueeze_", "squeeze_", "transpose_", "t_", "view_as",
    "unflatten", "flatten", "movedim", "_unsafe_index", "bernoulli_",
    "uniform_", "normal_", "random_", "randperm", "rand", "randn",
    "randint", "exponential_", "geometric_", "cauchy_", "log_normal_",
    "bernoulli", "multinomial", "_index_put_impl_", "index_put_",
    "index_put", "_pin_memory", "record_stream",
})
#: ops costed at one flop per INPUT element (XLA: reduce, scatter, sort)
_REDUCE_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "argmax", "argmin", "all", "any", "sort", "topk", "cumsum", "cumprod",
    "scatter", "scatter_add", "scatter_add_", "scatter_reduce",
    "index_add", "index_add_", "embedding_dense_backward", "_foreach_norm",
    "nansum", "count_nonzero",
})


def _tensors(x) -> List[torch.Tensor]:
    flat, _ = tree_flatten(x)
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _shapes(ts) -> str:
    return ";".join("x".join(str(d) for d in t.shape) or "s" for t in ts)


class Count(TorchDispatchMode):
    """A counting pass over the aten ops run inside ``with count:``.

    ``flops``, ``bytes``; ``by_kind`` (``matmul``, ``conv``, ``attention``,
    ``elementwise``, ``reduce``); ``by_layer`` ({scope or None: flops});
    ``matmul_by_dtype`` (which dtype carried the tensor-core work: the
    program's compute dtype); ``rows`` ({(op, shapes, scope, kind): [calls,
    flops, bytes]}).  A ``Count`` may be entered more than once (an
    executor's forward and its backward are one program)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_kind: Dict[str, float] = {}
        self.by_layer: Dict[Optional[str], float] = {}
        self.matmul_by_dtype: Dict[str, float] = {}
        self.rows: Dict[tuple, list] = {}

    def __enter__(self):
        global COUNTING
        COUNTING += 1
        try:
            return super().__enter__()
        except BaseException:
            COUNTING -= 1
            raise

    def __exit__(self, *exc):
        global COUNTING
        try:
            return super().__exit__(*exc)
        finally:
            COUNTING -= 1

    def add(self, op: str, kind: str, flops: float, nbytes: float,
            shapes: str = "", dtype=None) -> None:
        scope = _current_scope()
        self.flops += flops
        self.bytes += nbytes
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + flops
        self.by_layer[scope] = self.by_layer.get(scope, 0.0) + flops
        if dtype is not None and kind in ("matmul", "conv", "attention"):
            d = str(dtype).replace("torch.", "")
            self.matmul_by_dtype[d] = self.matmul_by_dtype.get(d, 0.0) + flops
        if HLO:
            row = self.rows.get((op, shapes, scope, kind))
            if row is None:
                row = self.rows[(op, shapes, scope, kind)] = [0, 0.0, 0.0]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_tls, "uncounted", 0):
            return out
        if func.is_view:
            return out
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        reg = _flop_registry()
        pk = func.overloadpacket
        dtype = None
        if pk in reg:
            flops = float(reg[pk](*args, **kwargs, out_val=out))
            kind = "conv" if "conv" in name else \
                "attention" if "attention" in name else "matmul"
            dtype = ins[0].dtype if ins else None
        elif name in _ZERO_FLOP_OPS:
            flops, kind = 0.0, "move"
        elif name in _REDUCE_OPS:
            first = ins[:1] if not name.startswith("_foreach") else ins
            flops, kind = float(sum(t.numel() for t in first)), "reduce"
        else:
            target = outs or (ins[:1] if not name.startswith("_foreach")
                              else _tensors(args[0]) if args else [])
            flops, kind = float(sum(t.numel() for t in target)), \
                "elementwise"
        nbytes = _nbytes(ins) + _nbytes(outs)
        self.add(name, kind, flops, float(nbytes),
                 _shapes(ins) if HLO else "", dtype)
        return out

    def table_text(self) -> str:
        lines = ["op\tshapes\tflops\tbytes\tscope\tkind\tcalls"]
        for (op, shapes, scope, kind), (n, f, b) in sorted(
                self.rows.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{op}\t{shapes}\t{f:.0f}\t{b:.0f}\t"
                         f"{scope or ''}\t{kind}\t{n}")
        return "\n".join(lines) + "\n"

    def compute_dtype(self) -> Optional[str]:
        if not self.matmul_by_dtype:
            return None
        return max(self.matmul_by_dtype.items(), key=lambda kv: kv[1])[0]


def _active_counts() -> List[Count]:
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, Count)]


def note_kernel(name: str, flops: float, nbytes: float, dtype=None) -> None:
    """Book a hand-written kernel's launch (invisible to the dispatcher)
    in every ``Count`` open on this thread.  Callers test ``COUNTING``
    first, so an uncounted launch pays one integer test."""
    if getattr(_tls, "uncounted", 0):
        return
    for c in _active_counts():
        c.add(name, "attention", float(flops), float(nbytes),
              "", dtype)


@contextlib.contextmanager
def uncounted():
    """Ops run inside are not booked: a kernel wrapper's plain version on
    the CPU, whose work ``note_kernel`` already booked by formula."""
    _tls.uncounted = getattr(_tls, "uncounted", 0) + 1
    try:
        yield
    finally:
        _tls.uncounted -= 1


@contextlib.contextmanager
def counting(name: str, label=None, signature=None, contracts=None):
    """Count the body as program ``name`` and note it (yields the open
    ``Count``, or None when introspection is off)."""
    if not ENABLED:
        yield None
        return
    c = Count()
    with c:
        yield c
    note_program(name, counted=c, label=label, signature=signature,
                 contracts=contracts)


def _meta(v, grad: bool):
    if not isinstance(v, torch.Tensor):
        return v
    t = torch.empty_like(v, device="meta")
    if grad and t.is_floating_point():
        t.requires_grad_()
    return t


def count_plan(plan, args: dict, aux: dict, is_train: bool, grad_names,
               fwd: str, bwd: Optional[str] = None,
               signature: Optional[str] = None) -> None:
    """Count a ``GraphPlan``'s forward as program ``fwd`` and, with
    ``bwd``, its backward over ``grad_names`` (``bwd == fwd``: one program
    for both) by running it on meta copies of its inputs: shapes only,
    nothing runs on the card and no kernel is launched, as the JAX package
    traces without executing.  A failure is logged and swallowed."""
    if not ENABLED:
        return
    from . import metrics as _metrics
    grad_names = set(grad_names or ())
    try:
        with _metrics.dispatch_unit(None):
            margs = {k: _meta(v, k in grad_names) for k, v in args.items()}
            maux = {k: _meta(v, False) for k, v in (aux or {}).items()}
            cf = Count()
            with cf, torch.set_grad_enabled(bool(bwd)):
                outs, _ = plan.run(margs, maux, is_train=is_train)
            cb = None
            if bwd:
                heads = [o for o in outs if isinstance(o, torch.Tensor)
                         and o.requires_grad]
                leaves = [margs[n] for n in margs if n in grad_names
                          and isinstance(margs[n], torch.Tensor)
                          and margs[n].requires_grad]
                cb = cf if bwd == fwd else Count()
                if heads and leaves:
                    with cb:
                        torch.autograd.grad(
                            heads, leaves, [torch.ones_like(h) for h in heads],
                            allow_unused=True)
        note_program(fwd, counted=cf, signature=signature)
        if cb is not None and cb is not cf:
            note_program(bwd, counted=cb, signature=signature)
    except Exception as e:  # noqa: BLE001 — never break what it observes
        log.debug("introspect: counting %s failed: %s", fwd, e)


def plan_signature(args: dict, *extra) -> str:
    """A program signature from its inputs' shapes and dtypes."""
    import hashlib
    key = (tuple((k, tuple(v.shape), str(v.dtype), bool(v.requires_grad))
                 for k, v in sorted(args.items())
                 if isinstance(v, torch.Tensor)), extra)
    return hashlib.sha1(repr(key).encode()).hexdigest()[:16]


# -- program records ---------------------------------------------------------
def _counted_fields(counted) -> dict:
    if counted is None:
        return {}
    if isinstance(counted, Count):
        table = counted.table_text() if HLO else None
        return {"flops": counted.flops, "bytes": counted.bytes,
                "by_kind": dict(counted.by_kind),
                "by_layer": dict(counted.by_layer),
                "dtype": counted.compute_dtype(), "hlo": table}
    d = dict(counted)
    return {"flops": d.get("flops"), "bytes": d.get("bytes"),
            "by_kind": dict(d.get("by_kind") or {}),
            "by_layer": dict(d.get("by_layer") or {}),
            "dtype": d.get("dtype"), "hlo": d.get("hlo")}


def note_program(name: str, counted=None, label=None, signature=None,
                 memory_stats=None, contracts=None) -> dict:
    """File one program's counted flops/bytes under ``name`` (``name:label``
    with a bounded qualifier such as a serving bucket's label): the one
    surface every chokepoint routes through.  ``counted`` is a ``Count`` or a
    dict with ``flops``, ``bytes`` and optionally ``by_kind``, ``by_layer``,
    ``dtype``, ``hlo``.  ``memory_stats`` (a ``memory.compiled_stats_dict``)
    is filed into the ledger's compiled table too.  Returns the record
    (``{}`` when introspection is off)."""
    if not ENABLED:
        return {}
    from . import goodput as _goodput
    if _goodput.ENABLED:
        _goodput.note_event("recompile")
    full = name if label is None else f"{name}:{label}"
    f = _counted_fields(counted)
    mem = memory_stats or {}
    if mem:
        from . import memory as _memory
        _memory.note_compiled(full, mem)
    hlo, truncated = f.get("hlo"), False
    if hlo is not None and len(hlo) > HLO_CAP_BYTES:
        hlo, truncated = hlo[:HLO_CAP_BYTES], True
    with _lock:
        prev = _programs.get(full) or {}
        rec = {
            "name": full,
            "flops": f.get("flops"),
            "bytes": f.get("bytes"),
            "by_kind": f.get("by_kind") or {},
            "by_layer": f.get("by_layer") or {},
            "dtype": f.get("dtype"),
            "memory": dict(mem),
            "signature": signature if signature is not None
            else prev.get("signature"),
            "hlo": hlo if hlo is not None else prev.get("hlo"),
            "hlo_truncated": truncated if hlo is not None
            else bool(prev.get("hlo_truncated")),
            "contracts": dict(contracts) if contracts is not None
            else prev.get("contracts"),
            "captures": (prev.get("captures") or 0) + 1,
        }
        _programs[full] = rec
        return dict(rec)


def note_jit(name: str, fn, *args, label=None, signature=None,
             contracts=None, **kwargs) -> dict:
    """Count one call of ``fn(*args, **kwargs)`` as program ``name``.  It
    RUNS ``fn`` (there is no retrace without execution here), so call it
    with a function whose effects may happen once more; the step hooks
    count their own first call instead (``counting``)."""
    if not ENABLED or fn is None:
        return {}
    c = Count()
    try:
        with c:
            fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — never break what it observes
        log.debug("introspect: counting %s failed: %s", name, e)
        return {}
    return note_program(name, counted=c, label=label, signature=signature,
                        contracts=contracts)


def programs() -> Dict[str, dict]:
    with _lock:
        return {k: dict(v) for k, v in _programs.items()}


def dump_hlo(name: str, directory: Optional[str] = None) -> str:
    """Write one program's counted op table to disk (atomic, a
    collision-free timestamped name).  Default directory:
    ``MXNET_FLIGHT_DIR``."""
    rec = programs().get(name)
    if rec is None or not rec.get("hlo"):
        raise MXNetError(
            f"no HLO captured for program {name!r} — set "
            f"MXNET_INTROSPECT_HLO=1 before the program is counted "
            f"(the port keeps its counted op table under that name; "
            f"captured: {sorted(programs())})")
    d = directory or os.environ.get("MXNET_FLIGHT_DIR", ".") or "."
    os.makedirs(d, exist_ok=True)
    safe = re.sub(r"[^\w.-]", "-", name)
    path = unique_path(d, f"hlo-{safe}", ".txt")
    atomic_write(path, rec["hlo"])
    return path


# -- per-layer attribution ---------------------------------------------------
def _layer_of(scope: str) -> str:
    """Graph node names carry an op-derived ``_fwd`` suffix that per-layer
    grouping strips; literal scopes (``optimizer``) pass through."""
    return scope[:-4] if scope.endswith("_fwd") else scope


def _group(by_scope, known) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for scope, flops in by_scope:
        if flops <= 0:
            continue
        layer = _layer_of(scope) if scope and scope in known \
            else UNATTRIBUTED
        out[layer] = out.get(layer, 0.0) + flops
    return out


def parse_hlo_flops(text: str, known: Optional[frozenset] = None,
                    kinds: Optional[tuple] = None) -> Dict[str, float]:
    """Read a counted op table (``dump_hlo``'s text) back into ``{layer:
    flops}``; rows without a known scope land under ``_unattributed``.
    ``kinds`` keeps only rows of those kinds (``("matmul", "conv")``)."""
    known = known if known is not None else known_scopes()
    rows = []
    for line in text.splitlines()[1:]:
        parts = line.split("\t")
        if len(parts) < 7:
            continue
        if kinds is not None and parts[5] not in kinds:
            continue
        rows.append((parts[4] or None, float(parts[2])))
    return _group(rows, known)


def per_layer(program: str = "whole_step", top: Optional[int] = None,
              step_time_s: Optional[float] = None,
              phase: Optional[str] = None) -> List[dict]:
    """The per-layer flops table of a counted program: ``[{layer, flops,
    pct, est_ms}]`` by flops (the ``_unattributed`` remainder is a row).
    ``est_ms`` spreads the phase's step time (the card's, where measured)
    or ``step_time_s`` over the layers by flops; measured per-layer time
    is in a profiler trace, under the same scope names."""
    rec = programs().get(program)
    if rec is None:
        raise MXNetError(
            f"program {program!r} has not been captured "
            f"(captured: {sorted(programs())})")
    by_layer = _group(list((rec.get("by_layer") or {}).items()),
                      known_scopes())
    total = sum(by_layer.values()) or 1.0
    if step_time_s is None:
        for ph in ([phase] if phase else
                   [p for p, pr in PHASE_PROGRAM.items() if pr == program]
                   + [program]):
            step_time_s = step_time(ph)
            if step_time_s is not None:
                break
    rows = [{"layer": k, "flops": v,
             "pct": round(100.0 * v / total, 2),
             "est_ms": round(step_time_s * 1e3 * v / total, 4)
             if step_time_s else None}
            for k, v in sorted(by_layer.items(), key=lambda kv: -kv[1])]
    return rows[:top] if top else rows


def attributed_pct(program: str = "whole_step") -> float:
    """Share (pct) of the program's counted flops attributed to named
    blocks."""
    rows = per_layer(program)
    return round(sum(r["pct"] for r in rows
                     if r["layer"] != UNATTRIBUTED), 2)


# -- the card's step time ----------------------------------------------------
_dev_lock = threading.Lock()
_pending: deque = deque()
_free_events: list = []
_dev_ewma: Dict[str, Tuple[float, int]] = {}
_PENDING_MAX = 64


def device_span_begin(phase: str, ewma: bool = True):
    """Record a start event on the current stream (a CUDA step about to
    run); returns the token ``device_span_end`` takes.  Goodput books the
    card's time of the step as compute instead of the host span
    (``goodput.defer_span``); ``ewma=False`` (a configuration's first,
    eager step) keeps it out of the step-time EWMA."""
    from . import goodput as _goodput
    if _pending:
        drain_device_times()
    with _dev_lock:
        pair = _free_events.pop() if _free_events else (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    pair[0].record()
    return phase, pair, _goodput.defer_span(phase), ewma


def device_span_end(token) -> None:
    phase, pair, book, ewma = token
    pair[1].record()
    with _dev_lock:
        _pending.append((phase, pair, book, ewma))
        while len(_pending) > _PENDING_MAX:     # never read: drop
            _pending.popleft()


def drain_device_times() -> int:
    """Fold every finished event pair into its phase's device EWMA (and
    goodput's compute), without waiting for the card; returns how many."""
    n = 0
    while True:
        with _dev_lock:
            if not _pending or not _pending[0][1][1].query():
                return n
            phase, pair, book, ewma = _pending.popleft()
        s = pair[0].elapsed_time(pair[1]) / 1e3
        with _dev_lock:
            _free_events.append(pair)
        _note_device(phase, s, book, ewma)
        n += 1


def _note_device(phase: str, s: float, book: bool = False,
                 ewma: bool = True) -> None:
    from . import flight as _flight
    if ewma:
        with _dev_lock:
            e, c = _dev_ewma.get(phase, (0.0, 0))
            _dev_ewma[phase] = (
                s if c == 0 else
                _flight._ALPHA * s + (1 - _flight._ALPHA) * e, c + 1)
    if book:
        from . import goodput as _goodput
        _goodput.observe_device(phase, s)


def device_step_time(phase: str) -> Optional[float]:
    """The warmed EWMA (seconds) of the card's time for ``phase``'s
    replays, or None."""
    from . import flight as _flight
    with _dev_lock:
        e, c = _dev_ewma.get(phase, (0.0, 0))
    return e if c >= _flight._WARMUP and e > 0.0 else None


def step_time(phase: str) -> Optional[float]:
    """The step time the introspector divides by: the card's (CUDA events)
    where its replays were timed, else the flight recorder's EWMA."""
    if _pending:
        drain_device_times()
    d = device_step_time(phase)
    if d is not None:
        return d
    from . import flight as _flight
    return _flight.watch_ewma(phase)


# -- MFU / roofline ----------------------------------------------------------
#: dense peak flops/s of the H100 by form factor and compute dtype
#: (NVIDIA's datasheet, dense): "float32" is the FMA rate, since the port
#: runs float32 with TF32 off; "tf32" applies when TF32 is on
_PEAK_TABLE = (
    ("H100 PCIe", {"bfloat16": 756e12, "float16": 756e12, "tf32": 378e12,
                   "float32": 51.2e12}),
    ("H100", {"bfloat16": 989.4e12, "float16": 989.4e12,
              "tf32": 494.7e12, "float32": 66.9e12}),
)
_CPU_NOMINAL_PEAK = 1e11
#: the programs whose counted compute dtype picks the peak, in order
_DTYPE_PROGRAMS = ("whole_step", "superstep", "gluon:fwd",
                   "executor:fwd_bwd", "executor:fwd")


def _device_name() -> Optional[str]:
    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:  # noqa: BLE001
        pass
    return None


def peak_flops(dtype: Optional[str] = None) -> Tuple[float, str]:
    """(peak flops/s, source): ``MXNET_PEAK_FLOPS`` > the H100 table for
    the card's name and ``dtype`` (default: the step program's counted
    compute dtype) > a nominal placeholder."""
    override = float(getenv("MXNET_PEAK_FLOPS", 0.0))
    if override > 0:
        return override, "MXNET_PEAK_FLOPS"
    name = _device_name()
    if name is None:
        return _CPU_NOMINAL_PEAK, "nominal-cpu"
    if dtype is None:
        progs = programs()
        dtype = next((progs[n]["dtype"] for n in _DTYPE_PROGRAMS
                      if progs.get(n, {}).get("dtype")), "float32")
    dtype = str(dtype).replace("torch.", "")
    if dtype == "float32" and torch.backends.cuda.matmul.allow_tf32:
        dtype = "tf32"
    for tag, row in _PEAK_TABLE:
        if tag in name and ("PCIe" in tag) == ("PCIe" in name):
            if dtype in row:
                return row[dtype], f"table:{tag}:{dtype}"
    return _CPU_NOMINAL_PEAK, "nominal-cuda"


def step_flops() -> Tuple[Optional[float], Optional[float], Optional[str]]:
    """(flops, bytes, phase) of one training step from the counted
    programs: the whole step, else the superstep (per step), else the sum
    of the fused path's three programs."""
    progs = programs()
    rec = progs.get("whole_step")
    if rec is not None and rec.get("flops"):
        return rec["flops"], rec.get("bytes"), "whole_step"
    rec = progs.get("superstep")
    if rec is not None and rec.get("flops"):
        return rec["flops"], rec.get("bytes"), "superstep"
    parts = [progs[n] for n in FUSED_STEP_PROGRAMS if n in progs]
    if parts and any(p.get("flops") for p in parts):
        return (sum(p.get("flops") or 0.0 for p in parts),
                sum(p.get("bytes") or 0.0 for p in parts) or None,
                "trainer_step")
    return None, None, None


def mfu(step_time_s: Optional[float] = None, flops: Optional[float] = None,
        bytes_per_step: Optional[float] = None,
        peak: Optional[float] = None) -> dict:
    """MFU and roofline: counted flops per step ÷ step time ÷ peak.  The
    step time defaults to the card's for the step's phase (the flight
    recorder's EWMA on the CPU); every input may be given.  ``{}`` until
    both the flops and a step time are known."""
    phase = None
    if flops is None:
        flops, b, phase = step_flops()
        if bytes_per_step is None:
            bytes_per_step = b
    if flops is None or flops <= 0:
        return {}
    source = "caller"
    if step_time_s is None and phase in FULL_STEP_PHASES:
        step_time_s = step_time(phase)
        source = "device" if device_step_time(phase) else "host"
    if not step_time_s or step_time_s <= 0:
        return {}
    pk, src = (peak, "caller") if peak else peak_flops()
    fps = flops / step_time_s
    out = {
        "flops_per_step": flops,
        "step_time_ms": round(step_time_s * 1e3, 4),
        "step_time_source": source,
        "flops_per_s": fps,
        "peak_flops": pk,
        "peak_source": src,
        "mfu": round(fps / pk, 6),
        "mfu_pct": round(100.0 * fps / pk, 4),
    }
    if bytes_per_step:
        out["bytes_per_step"] = bytes_per_step
        out["bytes_per_s"] = bytes_per_step / step_time_s
        out["arithmetic_intensity"] = round(flops / bytes_per_step, 4)
    return out


def phase_flops_map() -> Dict[str, float]:
    """{flight phase: counted flops per span} for the phases whose spans
    cover whole steps: the feed of the timeline's ``mxnet_flops_per_s``
    track.  A superstep's span covers K steps: its program's count is the
    K steps'."""
    out = {}
    progs = programs()
    for ph in FULL_STEP_PHASES:
        rec = progs.get(PHASE_PROGRAM[ph])
        if rec and rec.get("flops"):
            out[ph] = rec["flops"]
    return out


# -- perf-regression sentinel ------------------------------------------------
_BASELINE_SCHEMA = 1
_sent_counts: Dict[str, int] = {}
_sentinel: Dict[str, dict] = {}


def baseline_dir() -> Optional[str]:
    """``MXNET_PERF_BASELINE_DIR``, else ``perf-baselines/`` beside the
    compile cache (``MXNET_COMPILE_CACHE_DIR``); None disarms the
    sentinel."""
    d = os.environ.get("MXNET_PERF_BASELINE_DIR")
    if d:
        return d
    c = os.environ.get("MXNET_COMPILE_CACHE_DIR")
    return os.path.join(c, "perf-baselines") if c else None


def _platform() -> str:
    name = _device_name()
    return re.sub(r"[^\w.-]", "-", name) if name else "cpu"


def _signature_of(phase: str) -> str:
    rec = programs().get(PHASE_PROGRAM.get(phase, phase))
    sig = (rec or {}).get("signature")
    return sig or "unsigned"


def baseline_path(phase: str) -> Optional[str]:
    d = baseline_dir()
    if d is None:
        return None
    return os.path.join(
        d, f"{phase}-{_signature_of(phase)}-{_platform()}.json")


def _current_measurements(phase: str) -> Optional[dict]:
    from . import metrics as _metrics
    t = step_time(phase)
    if t is None:
        return None
    rec = programs().get(PHASE_PROGRAM.get(phase, phase))
    hbm = 0
    try:
        from . import memory as _memory
        if _memory.ENABLED:
            _dev, _host, peaks = _memory._live_split()
            hbm = int(sum(v for (sp, _t), v in peaks.items()
                          if sp == "device"))
    except Exception:  # noqa: BLE001
        pass
    return {
        "schema": _BASELINE_SCHEMA,
        "phase": phase,
        "platform": _platform(),
        "signature": _signature_of(phase),
        "step_time_p50_ms": round(t * 1e3, 4),
        "step_time_source": "device" if device_step_time(phase)
        else "host",
        "dispatches_per_step": float(
            _metrics.SUPERSTEP_DISPATCHES.get() if phase == "superstep"
            else _metrics.TRAINER_STEP_DISPATCHES.get()),
        "flops_per_step": (rec or {}).get("flops"),
        "hbm_peak_bytes": hbm,
        "written_at": time.time(),
    }


def _sentinel_entry(phase: str) -> dict:
    ent = _sentinel.get(phase)
    if ent is None:
        ent = _sentinel[phase] = {
            "baseline": None, "loaded": False, "corrupt": False,
            "active": False, "kind": None, "fired_at": None,
            "pending": False, "path": None, "wrote": False, "sig": None,
        }
    return ent


def _load_baseline(phase: str, ent: dict) -> None:
    ent["loaded"] = True
    path = baseline_path(phase)
    ent["path"] = path
    if path is None or not os.path.exists(path):
        return
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or \
                data.get("schema") != _BASELINE_SCHEMA or \
                not isinstance(data.get("step_time_p50_ms"), (int, float)) \
                or data["step_time_p50_ms"] <= 0:
            raise ValueError("missing/invalid required fields")
    except Exception as e:  # noqa: BLE001 — reject loudly, never crash
        ent["corrupt"] = True
        log.warning(
            "perf-regression sentinel: baseline %s is corrupt (%s) — "
            "REJECTED; the sentinel stays disarmed for this phase until "
            "introspect.refresh_baseline(%r) rewrites it", path, e, phase)
        return
    ent["baseline"] = data


def _write_baseline(phase: str, cur: dict, ent: dict) -> None:
    path = baseline_path(phase)
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write(path, json.dumps(cur, indent=1, sort_keys=True))
        ent["baseline"] = cur
        ent["path"] = path
        ent["wrote"] = True
        log.info("perf-regression sentinel: wrote baseline %s "
                 "(p50 %.3f ms)", path, cur["step_time_p50_ms"])
    except OSError as e:
        log.warning("perf-regression sentinel: baseline write to %s "
                    "failed: %s", path, e)


def sentinel_tick(phase: str) -> None:
    """Per-step hook of the training chokepoints (``Trainer.step``, the
    whole step, the superstep): one counter increment; the check runs
    every ``SENTINEL_EVERY`` steps once the phase's step time warmed."""
    if not ENABLED:
        return
    n = _sent_counts.get(phase, 0) + 1
    _sent_counts[phase] = n
    if n % SENTINEL_EVERY:
        return
    try:
        _sentinel_check(phase)
    except Exception as e:  # noqa: BLE001 — never break the step
        log.debug("perf sentinel check failed: %s", e)


def _sentinel_check(phase: str) -> None:
    if baseline_dir() is None:
        return
    cur = _current_measurements(phase)
    if cur is None:
        return
    ent = _sentinel_entry(phase)
    sig = _signature_of(phase)
    if ent["loaded"] and ent.get("sig") != sig:
        # a new signature (a batch or configuration change) has a
        # baseline of its own: never compare against the old one's
        ent = _sentinel[phase] = dict(ent, loaded=False, baseline=None,
                                      corrupt=False, active=False,
                                      kind=None, pending=False)
    if not ent["loaded"]:
        ent["sig"] = sig
        _load_baseline(phase, ent)
    if ent["baseline"] is None:
        if not ent["corrupt"]:
            _write_baseline(phase, cur, ent)
        return
    base = ent["baseline"]
    kind = None
    if cur["step_time_p50_ms"] > REGRESSION_FACTOR * \
            base["step_time_p50_ms"]:
        kind = "step_time"
    elif base.get("dispatches_per_step") and \
            cur["dispatches_per_step"] > base["dispatches_per_step"] + 0.5:
        kind = "dispatches"
    ent["current"] = cur
    if kind is None:
        ent["active"] = False
        ent["kind"] = None
        ent["pending"] = False
        return
    if ent["active"] and not ent.get("pending"):
        return      # the same episode: fired already
    ent["active"] = True
    ent["kind"] = kind
    now = time.monotonic()
    if ent["fired_at"] is not None and \
            now - ent["fired_at"] < REGRESSION_MIN_S:
        # inside the rate window: defer the firing, never drop it
        ent["pending"] = True
        return
    ent["pending"] = False
    ent["fired_at"] = now
    log.warning(
        "PERF REGRESSION (%s) on %s: step-time p50 %.3f ms vs baseline "
        "%.3f ms (factor %.1f), dispatches/step %.1f vs %.1f — baseline "
        "%s; if this change is intentional, refresh it with "
        "mx.observability.introspect.refresh_baseline(%r)",
        kind, phase, cur["step_time_p50_ms"], base["step_time_p50_ms"],
        REGRESSION_FACTOR, cur["dispatches_per_step"],
        base.get("dispatches_per_step", 0.0), ent["path"], phase)
    from . import metrics as _metrics
    if _metrics.ENABLED:
        _metrics.PERF_REGRESSIONS.inc(kind=kind, phase=phase)
    from . import journal as _journal
    if _journal.ENABLED:
        _journal.emit("perf_regression", durable=True, kind=kind,
                      phase=phase,
                      current_p50_ms=cur["step_time_p50_ms"],
                      baseline_p50_ms=base["step_time_p50_ms"])


def refresh_baseline(phase: str = "whole_step") -> Optional[dict]:
    """Rewrite the persisted baseline from the current warmed
    measurements (an intentional change) and clear an active
    regression.  None when nothing warmed or no directory is set."""
    if not ENABLED or baseline_dir() is None:
        return None
    cur = _current_measurements(phase)
    if cur is None:
        return None
    ent = _sentinel_entry(phase)
    ent["loaded"] = True
    ent["sig"] = _signature_of(phase)
    ent["corrupt"] = False
    ent["active"] = False
    ent["kind"] = None
    ent["pending"] = False
    _write_baseline(phase, cur, ent)
    return dict(cur)


def sentinel_armed() -> bool:
    return any(e.get("baseline") is not None
               for e in list(_sentinel.values()))


def regression_active() -> bool:
    return any(e.get("active") for e in list(_sentinel.values()))


def sentinel_state() -> dict:
    phases = {}
    for phase, e in sorted(list(_sentinel.items())):
        base, cur = e.get("baseline"), e.get("current")
        phases[phase] = {
            "baseline": dict(base) if base else None,
            "current": dict(cur) if cur else None,
            "active": bool(e.get("active")),
            "kind": e.get("kind"),
            "corrupt": bool(e.get("corrupt")),
            "path": e.get("path"),
        }
    return {"dir": baseline_dir(), "armed": sentinel_armed(),
            "regression_active": regression_active(), "phases": phases}


# -- surfaces ----------------------------------------------------------------
def snapshot_summary() -> dict:
    """``observability.snapshot()["programs"]``: per-program flops, bytes,
    peak, MFU and the sentinel's state."""
    progs = {}
    for name, rec in sorted(programs().items()):
        progs[name] = {
            "flops": rec.get("flops"),
            "bytes": rec.get("bytes"),
            "peak_bytes": (rec.get("memory") or {}).get("peak_bytes"),
            "signature": rec.get("signature"),
            "hlo_captured": bool(rec.get("hlo")),
            "captures": rec.get("captures", 0),
            "dtype": rec.get("dtype"),
        }
    return {"enabled": ENABLED, "hlo": HLO, "programs": progs,
            "mfu": mfu(), "sentinel": sentinel_state(),
            "known_scopes": len(_scopes)}


def report() -> dict:
    """Full program records (the op table elided to its length), per-layer
    tables, MFU and the sentinel's state."""
    out = {"enabled": ENABLED, "hlo": HLO, "mfu": mfu(),
           "sentinel": sentinel_state(), "programs": {}, "per_layer": {}}
    for name, rec in sorted(programs().items()):
        r = dict(rec)
        hlo = r.pop("hlo", None)
        r["hlo_bytes"] = len(hlo) if hlo else 0
        out["programs"][name] = r
        if r.get("by_layer"):
            out["per_layer"][name] = per_layer(name)
    return out


# -- lifecycle ---------------------------------------------------------------
def reset() -> None:
    """Drop every program record, known scope, device time and sentinel
    state (tests).  Baselines on disk stay."""
    with _lock:
        _programs.clear()
    _scopes.clear()
    _sent_counts.clear()
    _sentinel.clear()
    with _dev_lock:
        _pending.clear()
        _dev_ewma.clear()


def configure(hlo: Optional[bool] = None,
              hlo_cap_bytes: Optional[int] = None,
              sentinel_every: Optional[int] = None,
              regression_factor: Optional[float] = None,
              regression_min_s: Optional[float] = None) -> None:
    """Tune knobs at runtime; None leaves a knob as it is."""
    global HLO, HLO_CAP_BYTES, SENTINEL_EVERY, REGRESSION_FACTOR, \
        REGRESSION_MIN_S
    if hlo is not None:
        HLO = bool(hlo)
    if hlo_cap_bytes is not None:
        HLO_CAP_BYTES = max(1, int(hlo_cap_bytes))
    if sentinel_every is not None:
        SENTINEL_EVERY = max(1, int(sentinel_every))
    if regression_factor is not None:
        REGRESSION_FACTOR = float(regression_factor)
    if regression_min_s is not None:
        REGRESSION_MIN_S = float(regression_min_s)
