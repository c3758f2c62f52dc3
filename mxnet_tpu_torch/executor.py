"""Executor: a Symbol bound to tensors (parity: python/mxnet/executor.py,
src/executor/graph_executor.cc).

The counterpart of ``mxnet_tpu/executor.py`` over the port's ``GraphPlan``.
The JAX executor jits the graph and its vjp; here the plan runs eagerly and
torch's autograd differentiates it:

- ``forward(is_train=True)`` on an executor with a gradient to take runs
  the plan under ``torch.enable_grad`` on fresh leaf aliases of those
  arguments (``detach().requires_grad_()``: the same storage, so the bound
  tensors stay what the caller holds) and keeps the outputs for
  ``backward``.  Every other forward runs under ``torch.no_grad``, so
  ``predict`` and ``score`` build no graph.  The flash-attention op reaches
  its backward kernel K1b this way (``ops/flash_attention.py``).
- ``backward(out_grads=None)`` takes ``torch.autograd.grad`` of the kept
  outputs, with ones as the head gradients when none are given (as the JAX
  package does), and writes or adds each gradient into its buffer by
  ``grad_req``.  The graph is freed by it, as torch frees it: a second
  ``backward`` needs another forward (the JAX executor replays its
  snapshot instead).
- Aux states (BatchNorm's moving statistics) are written into their
  tensors once per forward, in place and unrecorded (``write_back``): no
  recorded op saved them, so torch's version check stays quiet.

With ``MXNET_BACKWARD_DO_MIRROR`` set, a train-mode forward with a
gradient to take runs the plan in ``MXNET_MIRROR_SEGMENTS`` checkpointed
segments (else sqrt(steps), at least 2): only the values crossing a
segment boundary are kept, and the backward runs each segment's forward
again (``GraphPlan.run``).

Not ported, and raising ``NotImplementedError`` that names the queue item
(ROADMAP.md): ``group2ctx`` model parallelism and row-sparse gradients
(item 6).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from .base import MXNetError, getenv
from .context import as_device
from .faultinject import fire as _fi_fire
from .ndarray import zeros
from .observability import introspect as _introspect
from .observability import memory as _memory
from .observability.tracing import trace_span
from .ndarray.register import write_back
from .symbol.graph import GraphPlan

_NULL = contextlib.nullcontext()


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a tensor, numpy array or list) on ``like``'s device, in its
    dtype."""
    if not isinstance(v, torch.Tensor):
        from .ndarray import array
        v = array(v, ctx=like.device)
    return v.to(device=like.device, dtype=like.dtype)


class Executor:
    def __init__(self, symbol, ctx, args: Dict[str, torch.Tensor],
                 args_grad: Dict[str, torch.Tensor], grad_req: Dict[str, str],
                 aux_states: Dict[str, torch.Tensor], group2ctx=None):
        if group2ctx:
            raise NotImplementedError(
                "Executor(group2ctx=...): model parallelism over several "
                "devices is not ported yet (ROADMAP.md, queue item 6: "
                "scale-out)")
        self._symbol = symbol
        self._ctx = ctx
        self._device = as_device(ctx)
        self.arg_dict = dict(args)
        self.grad_dict = dict(args_grad or {})
        self.grad_req = dict(grad_req)
        self.aux_dict = dict(aux_states or {})
        self._plan = GraphPlan(symbol)
        self._plan.specialize_init_shapes(
            {n: tuple(a.shape) for n, a in self.arg_dict.items()
             if a is not None})
        self._grad_names = [n for n in self._plan.arg_names
                            if self.grad_req.get(n, "null") != "null"]
        # MXNET_BACKWARD_DO_MIRROR: the train-mode forward runs in
        # checkpointed segments (GraphPlan.run), MXNET_MIRROR_SEGMENTS of
        # them, else sqrt(steps) and at least 2 (a whole-graph checkpoint
        # saves nothing)
        self._segments = 1
        if getenv("MXNET_BACKWARD_DO_MIRROR", 0):
            self._segments = int(getenv("MXNET_MIRROR_SEGMENTS", 0) or 0) \
                or max(2, int(len(self._plan.steps) ** 0.5))
        self._monitor = None
        self._monitor_all = False
        self._outputs: Optional[List[torch.Tensor]] = None
        # (outputs with their graph, {name: leaf}) of a train-mode forward
        # until backward consumes it
        self._graph = None

    # -- compute --------------------------------------------------------------
    def _load(self, kwargs) -> None:
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown forward argument {k}")
            tgt = self.arg_dict[k]
            v = _as_tensor(v, tgt)
            if v is tgt:
                continue
            if v.shape == tgt.shape:
                with torch.no_grad():
                    tgt.copy_(v)
            else:      # another batch size: the executor's own copy
                self.arg_dict[k] = v.clone()

    def forward(self, is_train: bool = False, **kwargs) -> List[torch.Tensor]:
        """Run the graph on the bound tensors (``kwargs`` first copied into
        the arguments they name); returns the outputs."""
        self._load(kwargs)
        with trace_span("forward", cat="executor"), \
                _memory.oom_guard("executor.forward"):
            return self._forward(is_train)

    def _forward(self, is_train):
        self._outputs = self._graph = None
        count = self._count(is_train) if _introspect.ENABLED else None
        with count if count is not None else _NULL:
            self._run_forward(is_train)
        if count is not None and not (is_train and self._grad_names):
            _introspect.note_program("executor:fwd", counted=count,
                                     signature=self._count_sig)
        return self._outputs

    def _run_forward(self, is_train):
        if is_train and self._grad_names:
            leaves = {n: self.arg_dict[n].detach().requires_grad_()
                      for n in self._grad_names}
            with torch.enable_grad():
                outs, new_aux = self._plan.run(
                    {**self.arg_dict, **leaves}, self.aux_dict,
                    is_train=True, segments=self._segments)
            self._graph = (outs, leaves)
        else:
            with torch.no_grad():
                outs, new_aux = self._plan.run(self.arg_dict, self.aux_dict,
                                               is_train=is_train)
        self._set_results(outs, new_aux)

    def _count(self, is_train):
        """The introspector's count of this forward (and, in train mode,
        of the backward that follows: ``executor:fwd_bwd``), the first
        time each signature runs; None after."""
        grads = bool(is_train and self._grad_names)
        sig = _introspect.plan_signature(self.arg_dict, grads)
        noted = self.__dict__.setdefault("_noted", set())
        if sig in noted:
            return None
        noted.add(sig)
        self._count_sig = sig
        count = _introspect.Count()
        self._pending_count = count if grads else None
        return count

    def backward(self, out_grads=None, is_train: bool = True) -> None:
        """The gradients of the last train-mode forward, with ``out_grads``
        (one per output, or one tensor) as the head gradients, ones where
        none is given; each written (``"write"``) or added (``"add"``) into
        its buffer in ``grad_dict``."""
        if self._graph is None:
            raise MXNetError(
                "backward needs a forward(is_train=True) of an executor "
                "with a gradient to take, and runs once per forward")
        outs, leaves = self._graph
        self._graph = None
        if out_grads is None:
            out_grads = [None] * len(outs)
        elif isinstance(out_grads, torch.Tensor):
            out_grads = [out_grads]
        heads, cots = [], []
        for o, g in zip(outs, out_grads):
            if o.requires_grad:
                heads.append(o)
                cots.append(torch.ones_like(o) if g is None
                            else _as_tensor(g, o))
        names = list(leaves)
        count, self._pending_count = \
            self.__dict__.get("_pending_count"), None
        with count if count is not None else _NULL:
            grads = torch.autograd.grad(
                heads, [leaves[n] for n in names], cots,
                allow_unused=True) if heads else [None] * len(names)
        if count is not None:
            _introspect.note_program("executor:fwd_bwd", counted=count,
                                     signature=self._count_sig)
        with torch.no_grad():
            for name, g in zip(names, grads):
                tgt = self.grad_dict.get(name)
                if tgt is None:
                    continue
                if self.grad_req.get(name) == "add":
                    if g is not None:
                        tgt.add_(g.to(tgt.dtype))
                elif g is None:
                    tgt.zero_()
                else:
                    tgt.copy_(g)

    def forward_backward(self, out_grads=None, **kwargs) -> List[torch.Tensor]:
        """One training step's forward and backward (the Module.fit path).
        An out-of-memory error in it dumps the ledger and the flight ring
        and is raised as ``DeviceMemoryError``; the ``memory.oom`` fault
        site injects one here."""
        self._load(kwargs)
        with trace_span("forward_backward", cat="executor"), \
                _memory.oom_guard("executor.forward_backward"):
            _fi_fire("memory.oom", at="executor")
            self._forward(True)
            self.backward(out_grads)
        return self._outputs

    def _set_results(self, outs, new_aux) -> None:
        self._outputs = [o.detach() for o in outs]
        write_back((tgt, new_aux[name]) for name, tgt in self.aux_dict.items()
                   if name in new_aux)
        if self._monitor is not None:
            if self._monitor_all:
                for name, arr in self.arg_dict.items():
                    self._monitor(name + "_input", arr)
            for name, o in zip(self._symbol.list_outputs(), self._outputs):
                self._monitor(name, o)

    @property
    def outputs(self) -> List[torch.Tensor]:
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs

    @property
    def output_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def debug_str(self) -> str:
        return self._symbol.debug_str()

    # -- utilities ------------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params: bool = False) -> None:
        """Copy ``arg_params`` and ``aux_params`` ({name: tensor}) into the
        bound tensors, in their dtype and on their device."""
        with torch.no_grad():
            for params, bound, kind in ((arg_params, self.arg_dict,
                                         "argument"),
                                        (aux_params, self.aux_dict,
                                         "aux state")):
                for k, v in (params or {}).items():
                    if k in bound:
                        if v is not bound[k]:
                            bound[k].copy_(_as_tensor(v, bound[k]))
                    elif not allow_extra_params:
                        raise MXNetError(f"unknown {kind} {k}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor for new input shapes: tensors whose shape is
        unchanged are shared, the others allocated anew (zeros)."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def keep_or_new(cur, shp):
            return cur if tuple(cur.shape) == tuple(shp) else \
                zeros(shp, ctx=self._device, dtype=cur.dtype)

        new_args = {n: keep_or_new(self.arg_dict[n], s)
                    for n, s in zip(self._plan.arg_names, arg_shapes)}
        new_aux = {n: keep_or_new(self.aux_dict[n], s)
                   for n, s in zip(self._plan.aux_names, aux_shapes)}
        grads = {n: zeros(new_args[n].shape, ctx=self._device,
                          dtype=new_args[n].dtype)
                 for n in self._grad_names}
        return Executor(self._symbol, self._ctx, new_args, grads,
                        self.grad_req, new_aux)

    def set_monitor_callback(self, callback, monitor_all=False) -> None:
        """Call ``callback(name, tensor)`` on every output after each
        forward (and on every argument, as ``name + "_input"``, with
        ``monitor_all``)."""
        self._monitor = callback
        self._monitor_all = bool(monitor_all)

