"""The whole Gluon training step as one program, with mixed precision
(parity: ``mxnet_tpu/gluon/wholestep.py``).

``WholeStepCompiler(net, loss_fn, trainer).step(data, label)`` runs
forward, loss, backward, the bucketed (2-bit compressed) reduce and the
fused optimizer update as one step function over the net and the loss
composed into one ``GraphPlan``.  The JAX package jits that function into
one donated XLA program; here, on a CUDA device, it is one
``torch.cuda.CUDAGraph`` (``StepGraph``): the first step of a new
configuration runs the function eagerly on a side stream (a real step:
it advances the weights, the optimizer states and the counts), the next
captures it and replays it once, and every later step copies the batch
into the graph's static input buffers and replays it.  Weights, gradients'
buckets, optimizer states, compression residuals, BatchNorm's moving
statistics, the loss scaler and the hyper-parameters
(``optimizer.HyperDeviceCache``) are updated in place, so the addresses
the graph holds stay valid.  A new data shape, AMP policy, optimizer
hyper key, compression layout, or storage behind any of those tensors
captures again, and says why.  On the CPU the same step function runs
eagerly: it is the plain version the tests hold against the JAX package.

Opt-in with ``MXNET_WHOLE_STEP=1``.  A model or trainer the step cannot
take (an optimizer without ``fused_step``, ``update_on_kvstore``, a
``grad_req`` other than "write", several devices, an op that is not
differentiable on a path from a trained parameter, a graph input that is
not a trainer parameter) runs the fused path (record, backward,
``Trainer.step``) with one warning.  The JAX package refuses any op that
is not differentiable; the port lets through those no gradient reaches
(the TransformerLM's ``_contrib_arange_like`` positions, made from the
data's shape), whose outputs are the same on both paths.  A
failure to capture or to replay raises ``MXNetError`` naming the op at
fault; nothing falls back to an eager step then.

``MXNET_AMP=bf16|fp16`` casts the float32 inputs of ``AMP_COMPUTE_OPS``
to the low-precision dtype for the op's compute and its outputs back to
float32 (inputs the op registry keeps float32, token ids, are never
cast), so master weights, optimizer states and the rest of the graph stay
float32.  ``fp16`` adds dynamic loss scaling on the device: the loss is
scaled, the gradients unscaled, a nonfinite gradient anywhere skips the
step (weights, states, residuals, moving statistics and the applied-step
counter keep their values through a ``where``) and halves the scale, and
``MXNET_LOSS_SCALE_WINDOW`` finite steps in a row double it.  The host's
update counts (``num_update``, lr schedules) advance on every step, as in
the JAX package; the device counter ``t`` only on applied ones.

A replay runs no Python, so the hooks sit around the replay call: each
step fires the ``trainer.step`` and ``device.unavailable`` fault sites on
the host before it, and the call is a ``whole_step`` span (``trace_span``
and a watched flight-recorder phase sampling the memory ledger) inside
``memory.oom_guard``.  A capture's time is booked as goodput's
``recompile`` (``StepGraph.capture_seconds``) and the change of the
allocator's bytes across it as the ledger's compiled stats.  The run
journal gets a milestone per step.

Each step publishes ``TRAINER_STEP_DISPATCHES`` (1: one replay) and
ticks the perf sentinel; a configuration's first step is counted as the
introspector's ``whole_step`` program, with the update and the reduce in
the ``optimizer`` and ``allreduce`` layer scopes, and each replay is
timed on the card by a CUDA event pair (``introspect.device_span_*``).

Not ported: the mesh and its sharded step (ROADMAP item 6).
"""
from __future__ import annotations

import hashlib
import logging
import time
from collections import OrderedDict

import torch

from .. import autograd
from .. import random as _random
from .. import symbol as sym_mod
from ..base import MXNetError, getenv
from ..faultinject import fire as _fi_fire
from ..observability import flight as _flight
from ..observability import goodput as _goodput
from ..observability import journal as _journal
from ..observability import introspect as _introspect
from ..observability import memory as _memory
from ..observability import metrics as _metrics
from ..observability.tracing import trace_span
from ..optimizer import _is_low_prec
from ..symbol.graph import GraphPlan
from .parameter import DeferredInitializationError
from .trainer import dtype_name

logger = logging.getLogger("mxnet_tpu_torch.gluon.wholestep")

# the step's data and label inputs, named so that no parameter can be
_DATA = "__wholestep_data__"
_LABEL = "__wholestep_label__"

#: ops whose compute runs in the low-precision dtype under MXNET_AMP
AMP_COMPUTE_OPS = frozenset({
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
})

_LP_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}
_SCALE_GROWTH = 2.0
_SCALE_BACKOFF = 0.5
_SCALE_MAX = float(2 ** 24)
# captured graphs kept per compiler (least recently used dropped)
_GRAPH_CACHE_MAX = 4


def amp_policy() -> str:
    """``MXNET_AMP`` as a dtype policy: "f32", "bf16" or "fp16"."""
    raw = str(getenv("MXNET_AMP", "")).strip().lower()
    if raw in ("", "0", "off", "none", "f32", "fp32", "float32"):
        return "f32"
    if raw in ("bf16", "bfloat16"):
        return "bf16"
    if raw in ("fp16", "f16", "float16"):
        return "fp16"
    raise MXNetError(
        f"MXNET_AMP={raw!r} not understood (use bf16, fp16, or off)")


def _amp_overrides(plan: GraphPlan, lp):
    """``step_overrides`` for ``GraphPlan.run`` that cast the float32
    inputs of ``AMP_COMPUTE_OPS`` (those not kept float32 by the registry)
    to ``lp`` and their ``lp`` outputs back to float32; autograd takes the
    casts' backward, so the op's backward products run in ``lp`` too."""
    over = {}
    for si, step in enumerate(plan.steps):
        if step.op.name not in AMP_COMPUTE_OPS:
            continue
        keep32 = frozenset(step.op.f32_inputs)

        def _run(p, ins, _op=step.op, _keep=keep32):
            cast = [a.to(lp) if (i not in _keep and a is not None
                                 and a.dtype == torch.float32) else a
                    for i, a in enumerate(ins)]
            out = _op.fn(p, *cast)
            out = out if isinstance(out, tuple) else (out,)
            return tuple(o.to(torch.float32) if o.dtype == lp else o
                         for o in out)

        over[si] = _run
    return over


class _Ineligible(RuntimeError):
    """A model or trainer the whole step cannot take: the fused path."""


class _AmpIneligible(_Ineligible):
    """``MXNET_AMP`` cannot apply to this model; checked on every step, so
    unsetting it runs the whole step again."""


def _leaves(state):
    """The tensors of an optimizer state (None, a tensor, nested tuples)."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _leaves(s)]


def update_groups(opt_, weights, device, cache):
    """The update's groups, as ``FusedUpdater.update_all`` makes them (by
    dtype and multi-precision): ``(multi_precision, positions, index
    tensor of the positions or None for all)``.  The index tensors are
    made once per grouping and kept in ``cache`` (a dict): a captured
    step reads them at their addresses."""
    groups = {}
    for pos, w in enumerate(weights):
        mp = opt_.multi_precision and _is_low_prec(w.dtype)
        groups.setdefault((w.dtype, mp), []).append(pos)
    key = (torch.device(device), tuple((str(k[0]), k[1], tuple(v))
                                       for k, v in groups.items()))
    if key not in cache:
        cache[key] = [(mp, poss, None if len(poss) == len(weights) else
                       torch.tensor(poss, device=device))
                      for (_, mp), poss in groups.items()]
    return cache[key]


def fused_update(opt_, keys, weights, grads, states, groups, hyper):
    """One ``fused_step`` per group, the hyper-parameters on the device."""
    for mp, poss, pos_t in groups:
        opt_.fused_step([keys[p] for p in poss], [weights[p] for p in poss],
                        [grads[p] for p in poss], [states[p] for p in poss],
                        mp, hyper=hyper.select(pos_t))


def step_generators(plan, device):
    """The port's generator for ``device`` when a step of ``plan`` draws
    from it (Dropout with p > 0, the random and sampling ops), for a
    captured graph to register; none on the CPU or when nothing draws."""
    if torch.device(device).type != "cuda":
        return []
    draws = any(s.op.name.startswith(("_random_", "_sample_"))
                or s.op.name == "_shuffle"
                or (s.op.name == "Dropout" and s.params.get("p", 0) > 0)
                for s in plan.steps)
    return [_random.generator(device)] if draws else []


def count_snapshot(opt_, keys):
    """What puts the host's update counts of ``keys`` back as they are now
    (a failed step must not count)."""
    prev_nu = opt_.num_update
    prev = {k: opt_._index_update_count.get(k) for k in keys}

    def rollback():
        opt_.num_update = prev_nu
        for k, c in prev.items():
            if c is None:
                opt_._index_update_count.pop(k, None)
            else:
                opt_._index_update_count[k] = c
    return rollback


class StepGraph:
    """One training step function as a CUDA graph, per configuration key.

    ``run(key, fn, device)``: on the CPU, ``fn()``.  On a CUDA device, the
    first call with a new ``key`` runs ``fn`` eagerly on a side stream (a
    real step, which also loads and configures every kernel it launches
    outside any capture), the next captures ``fn`` into a graph and
    replays it once, and the later ones replay it.  ``fn`` must read and
    write only tensors whose addresses ``key`` pins; what it returns are
    the graph's static outputs, rewritten by each replay.  ``key`` is a
    tuple of (field, value) pairs: a capture under a new key logs the
    fields that changed.  ``where()`` names the op or stage that was
    running when a capture or replay failed."""

    def __init__(self, name, where=None, program=None):
        self.name = name
        #: the introspector's program and flight phase name
        self.program = program or name
        self.where = where or (lambda: "the step")
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self._last = None
        #: the reason for each capture, in order, and its host seconds
        self.captures = []
        self.capture_seconds = []
        self.replays = 0
        #: host time of the last ``replay()`` call (its enqueue), ms
        self.replay_host_ms = None

    def _why(self, key):
        if self._last is None:
            return "first capture"
        old = dict(self._last)
        changed = []
        for f, v in key:
            was = old.get(f)
            if was == v:
                continue
            if isinstance(v, tuple) and isinstance(was, tuple) and \
                    len(v) == len(was) > 4:      # tensor addresses
                n = sum(a != b for a, b in zip(was, v))
                changed.append(f"{f}: {n} of {len(v)} moved")
            elif f == "storage" and isinstance(v, tuple) \
                    and isinstance(was, tuple):
                changed.append(f"{f}: {len(was)} -> {len(v)} tensors")
            else:
                changed.append(f"{f} {was!r} -> {v!r}")
        return "; ".join(changed) or "a configuration seen before"

    def run(self, key, fn, device, generators=(), count=None):
        """One step.  ``count`` (a signature string): count this call's
        ops as the program ``self.name`` (the introspector's once-per-
        configuration count; the caller passes it at a configuration's
        first step, which runs eagerly)."""
        with _metrics.dispatch_unit(self.program):
            if count is not None:
                with _introspect.counting(self.program, signature=count):
                    return self._run(key, fn, device, generators)
            return self._run(key, fn, device, generators)

    def _run(self, key, fn, device, generators):
        if torch.device(device).type != "cuda":
            return fn()
        ent = self._entries.get(key)
        if ent is None:
            ent = self._entries[key] = {"graph": None,
                                        "why": self._why(key)}
            while len(self._entries) > _GRAPH_CACHE_MAX:
                self._entries.popitem(last=False)
            self._last = key
            timed = _introspect.ENABLED or _goodput.ENABLED
            tok = _introspect.device_span_begin(self.program, ewma=False) \
                if timed else None
            out = self._eager(fn, device)
            if tok is not None:
                _introspect.device_span_end(tok)
            return out
        self._entries.move_to_end(key)
        if ent["graph"] is None:
            t0 = time.perf_counter()
            before = torch.cuda.memory_stats(device) \
                if _memory.ENABLED else None
            ent["graph"], ent["out"] = self._capture(fn, generators)
            dt = time.perf_counter() - t0
            self.capture_seconds.append(dt)
            if _goodput.ENABLED:
                # a capture is the card's compile: goodput's recompile
                _goodput.attribute("recompile", dt)
            if before is not None:
                _memory.note_compiled(self.name, _memory.compiled_stats_dict(
                    before, torch.cuda.memory_stats(device)))
            self.captures.append(ent["why"])
            (logger.info if len(self.captures) == 1 else logger.warning)(
                "%s: captured a CUDA graph (%s)", self.name, ent["why"])
        timed = _introspect.ENABLED or _goodput.ENABLED
        try:
            t0 = time.perf_counter()
            tok = _introspect.device_span_begin(self.program) if timed else None
            ent["graph"].replay()
            if tok is not None:
                _introspect.device_span_end(tok)
            self.replay_host_ms = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # noqa: BLE001 — name the step, never retry
            raise MXNetError(f"{self.name}: replaying the captured step "
                             f"failed: {type(e).__name__}: {e}") from e
        self.replays += 1
        self._last = key
        return ent["out"]

    @staticmethod
    def _eager(fn, device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        return out

    def _capture(self, fn, generators):
        g = torch.cuda.CUDAGraph()
        for gen in generators:
            register = getattr(g, "register_generator_state", None)
            if register is None:
                raise MXNetError(
                    f"{self.name}: the step draws random numbers from the "
                    "port's generator (dropout > 0), and this PyTorch "
                    "cannot register a generator with a CUDA graph "
                    "(CUDAGraph.register_generator_state); a replay "
                    "would reuse one frozen mask")
            register(gen)
        try:
            with torch.cuda.graph(g):
                out = fn()
        except Exception as e:  # noqa: BLE001 — name the op at fault
            raise MXNetError(
                f"{self.name}: capturing the step into a CUDA graph failed "
                f"at {self.where()}: {type(e).__name__}: {e}") from e
        return g, out


class WholeStepCompiler:
    """One training step per call, as one captured program on the card.

    ::

        stepper = WholeStepCompiler(net, loss_fn, trainer)
        for x, y in batches:
            loss = stepper.step(x, y)      # per-sample loss

    ``step`` runs the whole step when ``MXNET_WHOLE_STEP=1`` and the model
    and trainer are eligible, and the fused path (record, backward,
    ``Trainer.step``) otherwise; in float32 the returned losses and the
    trajectory are the same either way.  ``net`` is a ``HybridBlock``
    (hybridized or not) and ``loss_fn`` a loss block taking ``(pred,
    label)``; they are composed into one graph."""

    def __init__(self, net, loss_fn, trainer):
        self.net = net
        self.loss_fn = loss_fn
        self.trainer = trainer
        self._built = None
        self._fallback_reason = None
        self._warned = False
        self._amp_warned = False
        self._amp_env_checked = False
        self._stage = None
        self._static = {}
        self._amp_cache = {}
        self._groups = {}
        self._graph = StepGraph("whole-step", self._where,
                                program="whole_step")
        self._noted_keys = set()

    # -- public entry ----------------------------------------------------
    def step(self, data, label, batch_size=None):
        """One training step on (data, label); returns the per-sample loss,
        what ``loss_fn(net(data), label)`` gives on the fused path."""
        bs = batch_size if batch_size is not None else int(data.shape[0])
        if self._fallback_reason is not None:
            return self._fallback(data, label, bs)
        if not getenv("MXNET_WHOLE_STEP", False):
            self._warn_amp_without_wholestep()
            return self._fallback(data, label, bs)
        if autograd.is_recording():
            raise MXNetError(
                "WholeStepCompiler.step() must not be called inside "
                "autograd.record() — it manages forward/backward itself")
        policy = amp_policy()
        try:
            built = self._ensure_built()
            return self._run(built, data, label, bs, policy)
        except DeferredInitializationError:
            # the fused path resolves the shapes; the next step builds
            return self._fallback(data, label, bs)
        except _AmpIneligible as e:
            if not self._amp_warned:
                logger.warning(
                    "MXNET_AMP requested but %s — running the fused f32 "
                    "path while the policy is set", e)
                self._amp_warned = True
            return self._fallback(data, label, bs)
        except _Ineligible as e:
            self._note_fallback(str(e))
            return self._fallback(data, label, bs)

    __call__ = step

    @property
    def active(self) -> bool:
        """True once the whole step is built and no fallback was taken."""
        return self._built is not None and self._fallback_reason is None

    @property
    def fallback_reason(self):
        return self._fallback_reason

    @property
    def captures(self):
        """Why each CUDA graph of this compiler was captured, in order."""
        return list(self._graph.captures)

    # -- the fused path --------------------------------------------------
    def _fallback(self, data, label, batch_size):
        with autograd.record():
            out = self.net(data)
            loss = self.loss_fn(out, label)
        loss.backward()
        self.trainer.step(batch_size)
        return loss

    def _warn_amp_without_wholestep(self) -> None:
        if self._amp_env_checked:
            return
        self._amp_env_checked = True
        try:
            policy = amp_policy()
        except MXNetError:
            return
        if policy != "f32":
            logger.warning(
                "MXNET_AMP=%s is set but MXNET_WHOLE_STEP is not enabled "
                "— autocast and loss scaling only exist inside the "
                "whole-step program; training runs full f32", policy)

    def _note_fallback(self, reason: str) -> None:
        self._fallback_reason = reason
        if not self._warned:
            try:
                policy = amp_policy()
            except MXNetError:
                policy = "f32"
            amp_note = "" if policy == "f32" else (
                f"; MXNET_AMP={policy} is INERT on the fallback path — "
                "training runs full f32 with no loss scaling")
            logger.warning(
                "MXNET_WHOLE_STEP=1 requested but this model/trainer is "
                "not whole-step compilable (%s) — using the fused "
                "multi-program path%s", reason, amp_note)
            self._warned = True

    # -- build -----------------------------------------------------------
    def _ensure_built(self):
        if self._built is not None:
            return self._built
        tr = self.trainer
        if not tr._kv_initialized:
            tr._init_kvstore()
        self._check_trainer(tr)
        plan, out_sym = self._trace_graph()
        built = self._bind_graph(tr, plan)
        built["symbol"] = out_sym
        self._built = built
        return built

    @staticmethod
    def _check_trainer(tr) -> None:
        if tr._update_on_kvstore:
            raise _Ineligible("update_on_kvstore trainers push per key "
                              "through the kvstore")
        if not tr._fused:
            raise _Ineligible("MXNET_FUSED_TRAINER=0 pins the legacy path")
        if not getattr(tr._updater.optimizer, "fused", False):
            raise _Ineligible(
                f"optimizer {type(tr._updater.optimizer).__name__} has no "
                "fused_step")
        for p in tr._params:
            if p.grad_req not in ("write", "null"):
                raise _Ineligible(
                    f"grad_req={p.grad_req!r} on {p.name} (the step writes "
                    "gradients)")
            if p.grad_req != "null" and not p.is_deferred and \
                    len(p.list_ctx()) != 1:
                raise _Ineligible(f"multi-device copies of {p.name}")

    def _trace_graph(self):
        """The net and the loss composed into one ``GraphPlan``."""
        out = self.net(sym_mod.Variable(_DATA))
        if isinstance(out, (list, tuple)):
            if len(out) != 1:
                raise _Ineligible("multi-output networks")
            out = out[0]
        loss_sym = self.loss_fn(out, sym_mod.Variable(_LABEL))
        if isinstance(loss_sym, (list, tuple)):
            if len(loss_sym) != 1:
                raise _Ineligible("multi-output losses")
            loss_sym = loss_sym[0]
        plan = GraphPlan(loss_sym)
        for s in plan.steps:
            if s.op.name == "Custom":
                raise _Ineligible(
                    f"op {s.op.name} is not whole-step traceable")
        return plan, loss_sym

    @staticmethod
    def _bind_graph(tr, plan):
        """Graph inputs onto trainer parameters, in the fused path's order
        and bucket layout, so that optimizer states and residuals are
        interchangeable between the two paths."""
        params_by_name = {p.name: p for p in tr._params}
        gset, cnames = set(), []
        for n in plan.arg_names:
            if n in (_DATA, _LABEL):
                continue
            p = params_by_name.get(n)
            if p is None:
                raise _Ineligible(
                    f"graph input {n!r} is not a trainer parameter")
            (gset.add(n) if p.grad_req != "null" else cnames.append(n))
        for n in plan.aux_names:
            if n not in params_by_name:
                raise _Ineligible(
                    f"auxiliary state {n!r} is not a trainer parameter")
        if not gset:
            raise _Ineligible("no trainable parameters in the graph")
        # the steps a gradient flows through: an op that is not
        # differentiable there would be differentiated by autograd here
        # and not on an eager fused path
        reached = set()
        for si, s in enumerate(plan.steps):
            if any((r[0] == "var" and r[1] in gset) or
                   (r[0] == "val" and r[1][0] in reached)
                   for r in s.in_refs):
                if not s.op.differentiable:
                    raise _Ineligible(
                        f"op {s.op.name} is not whole-step traceable")
                reached.add(si)
        live = [(i, p) for i, p in enumerate(tr._params)
                if p.grad_req != "null"]
        missing = [p.name for _, p in live if p.name not in gset]
        if missing:
            raise _Ineligible(
                f"trainable parameters unused by the graph: {missing[:3]}"
                " (their gradients would go stale)")
        idx = tuple(i for i, _ in live)
        sig = tuple((tuple(p.data().shape), dtype_name(p.data().dtype))
                    for _, p in live)
        device = live[0][1].data().device
        if any(p.data().device != device for p in params_by_name.values()):
            raise _Ineligible("parameters on more than one device")
        bk = tr._ensure_bucketer(sig, idx)
        return {"plan": plan, "idx": idx,
                "gnames": [p.name for _, p in live], "cnames": tuple(cnames),
                "aux_names": tuple(plan.aux_names),
                "params": params_by_name, "bk": bk, "sig": sig,
                "device": device}

    # -- one step --------------------------------------------------------
    def _where(self):
        plan = self._built["plan"] if self._built else None
        if self._stage == "forward" and plan is not None \
                and plan.running is not None:
            s = plan.steps[plan.running]
            return f"the forward, node {s.node.name!r} (op {s.op.name})"
        return self._stage or "the step"

    def _pending_ts(self, idx):
        """A state file's applied-step counts, taken once when the device
        counter is seeded."""
        tr = self.trainer

        def pending():
            pend = tr._applied_ts_pending
            if pend is not None and tuple(pend[0]) == tuple(idx):
                tr._applied_ts_pending = None
                return pend[1]
            return None
        return pending

    def _prepare(self, built, policy, bs):
        """What a step reads besides the batch: the compression threshold
        and residuals, the scaler, the optimizer states (on the device);
        advances nothing."""
        tr = self.trainer
        if policy != "f32" and any(d != "float32" for _, d in built["sig"]):
            raise _AmpIneligible(
                f"MXNET_AMP={policy} needs float32 master weights")
        gc = tr._kv._gc if tr._kv is not None else None
        thr = gc.threshold if gc is not None else None
        if thr is not None and tr._residuals is None:
            tr._residuals = tr._init_residuals(built["bk"])
        scaler = tr._ensure_scaler() if policy == "fp16" else None
        upd = tr._updater
        params = built["params"]
        for i, n in zip(built["idx"], built["gnames"]):
            upd._ensure_state(i, params[n].data())
        tr._optimizer.rescale_grad = tr._scale / bs
        return thr, scaler

    def _run(self, built, data, label, bs, policy):
        tr = self.trainer
        # before anything advances: an injected raise is a step that
        # failed without consuming state (a replay runs no Python, so the
        # sites fire here, on the host)
        _fi_fire("trainer.step", step=tr._step_id)
        d0 = _metrics.step_dispatches()
        thr, scaler = self._prepare(built, policy, bs)
        upd = tr._updater
        opt_ = upd.optimizer
        idx = built["idx"]
        device = built["device"]
        rollback = count_snapshot(opt_, idx)
        for i in idx:
            opt_._update_count(i)
        try:
            hyper, counts_t = upd.hyper_cache.arrays(
                opt_, idx, device, pending_ts=self._pending_ts(idx))
            x = self._feed("data", 0, data, device)
            y = self._feed("label", 0, label, device)
            args = self._step_args(built, policy, thr, scaler)
            gens = step_generators(built["plan"], device)
            key = self._key(built, policy, thr, scaler, opt_, (x, y),
                            args, hyper, gens)
            _fi_fire("device.unavailable", step=tr._step_id)
            with trace_span("whole_step", cat="trainer"), \
                    _flight.phase_span("whole_step", cat="step",
                                       step=tr._step_id, watch=True,
                                       mem=True), \
                    _memory.oom_guard("wholestep.step"):
                loss = self._graph.run(
                    key, lambda: self._body(built, policy, thr, scaler, x,
                                            y, hyper, *args), device, gens,
                    count=self._note(built, policy, thr, opt_, (x, y)))
        except Exception:
            rollback()
            raise
        upd.hyper_cache.commit(idx, device, counts_t)
        upd.dtype_policy = policy
        tr._applied_ts = (idx, hyper.t)
        tr._step_id += 1
        if _metrics.ENABLED:
            _metrics.TRAINER_STEP_DISPATCHES.set(
                _metrics.step_dispatches() - d0)
        if _introspect.ENABLED:
            _introspect.sentinel_tick("whole_step")
        if _journal.ENABLED:
            _journal.maybe_milestone(tr._step_id, source="whole_step")
        return loss.clone()

    def _note(self, built, policy, thr, opt_, feeds, k=None):
        """The introspector's signature of this step's program, the first
        time this configuration runs (None after: counted once).  Data
        shapes fold in, so a batch-size change selects its own perf
        baseline."""
        if not _introspect.ENABLED:
            return None
        conf = (type(opt_).__name__, policy, thr is not None, k,
                tuple((tuple(t.shape), t.dtype) for t in feeds))
        if (id(built), conf) in self._noted_keys:
            return None
        self._noted_keys.add((id(built), conf))
        return hashlib.sha1(repr((built["sig"],) + conf[:4] + (tuple(
            (s, str(d)) for s, d in conf[4]),)).encode()).hexdigest()[:16]

    def _feed(self, name, slot, value, device):
        """The batch on the device: on a card, copied into the static
        buffer the captured graph reads for (name, slot, shape, dtype)."""
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        if torch.device(device).type != "cuda":
            return value.to(device)
        if value.device.type == "cpu":
            _metrics.note_h2d()
        key = (name, slot, tuple(value.shape), value.dtype)
        buf = self._static.get(key)
        if buf is None:
            buf = self._static[key] = torch.empty(
                value.shape, dtype=value.dtype, device=device)
        with torch.no_grad():
            buf.copy_(value)
        return buf

    def _step_args(self, built, policy, thr, scaler):
        """The tensors a step reads and writes in place: weights, consts,
        aux, optimizer states, residuals; and the update's groups."""
        tr = self.trainer
        params = built["params"]
        upd = tr._updater
        opt_ = upd.optimizer
        weights = [params[n].data() for n in built["gnames"]]
        consts = {n: params[n].data() for n in built["cnames"]}
        aux = {n: params[n].data() for n in built["aux_names"]}
        states = [upd.states[i] for i in built["idx"]]
        residuals = tr._residuals if thr is not None else []
        groups = update_groups(opt_, weights, built["device"], self._groups)
        return weights, consts, aux, states, residuals, groups

    def _key(self, built, policy, thr, scaler, opt_, feeds, args, hyper,
             gens):
        """What a captured graph depends on, as (field, value) pairs."""
        weights, consts, aux, states, residuals, groups = args
        tensors = list(weights) + list(consts.values()) + list(aux.values())
        tensors += [g[2] for g in groups if g[2] is not None]
        for s in states:
            tensors += _leaves(s)
        tensors += list(residuals) + list(feeds) + list(hyper)
        if scaler is not None:
            tensors += [scaler["scale"], scaler["good"]]
        return (("data", tuple((tuple(t.shape), str(t.dtype))
                              for t in feeds)),
                ("amp policy", policy if scaler is None
                 else f"fp16/window {scaler['window']}"),
                ("optimizer", opt_.fused_hyper_key()),
                ("compression", None if thr is None
                 else (thr, built["bk"].sizes)),
                ("storage", tuple(t.data_ptr() for t in tensors)),
                ("generator", tuple(id(g) for g in gens)))

    def _amp(self, plan, policy):
        lp = _LP_DTYPES.get(policy)
        if lp is None:
            return None
        over = self._amp_cache.get((id(plan), policy))
        if over is None:
            over = self._amp_cache[(id(plan), policy)] = \
                _amp_overrides(plan, lp)
        return over

    def _body(self, built, policy, thr, scaler, data, label, hyper,
              weights, consts, aux, states, residuals, groups):
        """The step function: forward, loss, backward, (compressed)
        reduce, update, all in place.  Returns the per-sample loss."""
        plan = built["plan"]
        gnames = built["gnames"]
        idx = built["idx"]
        opt_ = self.trainer._updater.optimizer
        self._stage = "forward"
        leaves = [w.detach().requires_grad_() for w in weights]
        m = dict(consts)
        m[_DATA] = data
        m[_LABEL] = label
        m.update(zip(gnames, leaves))
        with torch.enable_grad(), autograd.train_mode():
            outs, new_aux = plan.run(m, aux, is_train=True,
                                     step_overrides=self._amp(plan, policy))
            loss = outs[0]
            total = loss.to(torch.float32).sum()
            if scaler is not None:
                total = total * scaler["scale"]
        self._stage = "the backward"
        grads = list(torch.autograd.grad(total, leaves))
        with torch.no_grad():
            finite = None
            if scaler is not None:
                self._stage = "the loss scaler's unscale"
                inv = 1.0 / scaler["scale"]
                grads = [(g.to(torch.float32) * inv).to(g.dtype)
                         for g in grads]
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in grads]).all()
            if thr is not None:
                from ..kvstore import reduce_buckets_inline
                self._stage = "the bucketed 2-bit reduce"
                bk = built["bk"]
                with _introspect.layer_scope("allreduce"):
                    red, new_res = reduce_buckets_inline(
                        bk.flatten(grads), residuals, thr)
                    grads = bk.unflatten(red)
            mutable = []
            if scaler is not None:
                mutable = list(weights) + [t for s in states
                                           for t in _leaves(s)]
                old = [t.clone() for t in mutable]
            self._stage = "the fused update"
            with _introspect.layer_scope("optimizer"):
                fused_update(opt_, idx, weights, grads, states, groups,
                             hyper)
            self._stage = "the write-back"
            if scaler is not None:
                for t, o in zip(mutable, old):
                    t.copy_(torch.where(finite, t, o))
            if thr is not None:
                for r, nr in zip(residuals, new_res):
                    r.copy_(nr if finite is None
                            else torch.where(finite, nr, r))
            for n, tgt in aux.items():
                new = new_aux.get(n)
                if new is not None and new is not tgt:
                    tgt.copy_(new if finite is None
                              else torch.where(finite, new, tgt))
            if scaler is None:
                hyper.t.add_(1)
            else:
                hyper.t.copy_(torch.where(finite, hyper.t + 1, hyper.t))
                self._scale_update(scaler, finite)
        self._stage = None
        return loss.detach()

    @staticmethod
    def _scale_update(scaler, finite):
        """Growth after ``window`` finite steps, backoff on a nonfinite
        one (parity: ``mxnet_tpu/gluon/wholestep.py:748-775``)."""
        scale, good = scaler["scale"], scaler["good"]
        new_good = torch.where(finite, good + 1, torch.zeros_like(good))
        grow = new_good >= scaler["window"]
        new_scale = torch.where(
            grow, torch.clamp(scale * _SCALE_GROWTH, max=_SCALE_MAX), scale)
        new_scale = torch.where(
            finite, new_scale, torch.clamp(scale * _SCALE_BACKOFF, min=1.0))
        good.copy_(torch.where(grow, torch.zeros_like(new_good), new_good))
        scale.copy_(new_scale)
