"""Graph plan, its eager interpreter, and shape/type inference.

The counterpart of ``mxnet_tpu/symbol/graph.py``.  ``GraphPlan`` orders a
Symbol's nodes once and ``run`` calls each op's torch function on the
tensors it is given, on their device: PyTorch runs eagerly, so the plan is
the whole executor, and the CUDA kernels behind an op (flash attention)
launch from it as they do from the ``nd`` functions.

Shape inference runs the same plan on tensors on ``torch.device("meta")``:
they carry shape and dtype and no data, so nothing is computed and no
kernel launches (the JAX package traces with ``jax.eval_shape`` instead).
Parameter-shape hooks reproduce the reference ops' InferShape for
auto-created weights (the FullyConnected weight from ``num_hidden`` and the
data's trailing width, src/operator/nn/fully_connected-inl.h; convolution
weights, BatchNorm's four per-channel vectors) and the loss outputs'
labels, for the ops the port has.

``run(segments=k)`` with k > 1 is ``MXNET_BACKWARD_DO_MIRROR``'s
rematerialisation: the steps are cut into k contiguous segments (bounds
``round(i * n / k)``, as the JAX package's ``_segment_layout``), each run
under ``torch.utils.checkpoint`` (non-reentrant), so that only the values
that cross a segment boundary are kept for the backward and each segment's
forward runs again inside it.  The aux outputs of the first run are the
ones returned (the recomputation's are dropped), and the port's own
generator (dropout) is put back to its state of the first run before a
segment is recomputed, so the same masks are drawn.

``run(step_overrides={step index: fn(params, inputs)})`` calls ``fn`` in
place of that step's op (the whole-step program's mixed-precision casts
around the matrix products ride it); as in the JAX package, a run with
overrides is not segmented.  ``running`` holds the index of the step
being run, so a failure inside a captured step can name its op.

Each node runs inside ``introspect.layer_scope(node name)``: the
introspector's counting pass books its flops (and, through the autograd
nodes the scope tags, its backward's) under that layer, and a running
profiler shows the range.  A run is one dispatch (``dispatch_unit``).

Init ops (``_zeros``/``_ones``/``_full``) whose ``shape`` has 0-dims (an
``mx.rnn`` cell's begin state, ``(0, H)``) are unknown until shape
inference substitutes the batch, as for 0-dim variable hints; an executor
fixes them at bind (``specialize_init_shapes``).

Not ported: the channels-last layout pass (TPU only).
"""
from __future__ import annotations

import ast
import math
from typing import Callable, Dict, List, Optional

import numpy as _np
import torch
import torch.utils.checkpoint

from .. import random as _random
from ..base import MXNetError, np_dtype, torch_dtype
from ..observability import introspect as _introspect
from ..observability import metrics as _metrics
from ..ops import registry as _reg
from ..ops.custom import _custom_shape_hook
from .symbol import Symbol


# op name -> fn(params, in_shapes) -> {input_index: shape} for unknown-var fill
def _fc_hook(p, shp):
    d = shp[0]
    red = math.prod(d[1:]) if p.get("flatten", True) else d[-1]
    out = {1: (p["num_hidden"], red)}
    if not p.get("no_bias"):
        out[2] = (p["num_hidden"],)
    return out


def _conv_hook(p, shp):
    d = shp[0]
    out = {1: (p["num_filter"], d[1] // p.get("num_group", 1))
           + tuple(p["kernel"])}
    if not p.get("no_bias"):
        out[2] = (p["num_filter"],)
    return out


def _deconv_hook(p, shp):
    d = shp[0]
    out = {1: (d[1], p["num_filter"] // p.get("num_group", 1))
           + tuple(p["kernel"])}
    if not p.get("no_bias"):
        out[2] = (p["num_filter"],)
    return out


def _bn_hook(p, shp):
    c = shp[0][p.get("axis", 1) % len(shp[0])]
    return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}


def _in_hook(p, shp):
    c = shp[0][1]
    return {1: (c,), 2: (c,)}


def _prelu_hook(p, shp):
    if p.get("act_type") == "prelu" and len(shp) > 1:
        return {1: (shp[0][1] if len(shp[0]) > 1 else shp[0][0],)}
    return {}


def _ln_hook(p, shp):
    c = shp[0][p.get("axis", -1) % len(shp[0])]
    return {1: (c,), 2: (c,)}


def _emb_hook(p, shp):
    return {1: (p["input_dim"], p["output_dim"])}


def _softmax_output_hook(p, shp):
    """The label's shape from the data's (src/operator/softmax_output-inl.h)."""
    d = shp[0]
    if p.get("multi_output"):
        return {1: (d[0],) + tuple(d[2:])}
    if p.get("preserve_shape"):
        return {1: tuple(d[:-1])}
    return {1: (d[0],)}


def _regression_hook(p, shp):
    return {1: tuple(shp[0])}


def _rnn_hook(p, shp):
    """The fused RNN's packed parameters and its states
    (``ops/sequence.py:rnn_param_size``)."""
    from ..ops.sequence import rnn_param_size
    T, B, I = shp[0]
    L, H = p["num_layers"], p["state_size"]
    d = 2 if p.get("bidirectional") else 1
    out = {1: (rnn_param_size(L, I, H, bool(p.get("bidirectional")),
                              p["mode"]),),
           2: (L * d, B, H)}
    if p["mode"] == "lstm":
        out[3] = (L * d, B, H)
    return out


PARAM_SHAPE_HOOKS: Dict[str, Callable] = {
    "Custom": _custom_shape_hook,
    "SoftmaxOutput": _softmax_output_hook,
    "LinearRegressionOutput": _regression_hook,
    "LogisticRegressionOutput": _regression_hook,
    "MAERegressionOutput": _regression_hook,
    "FullyConnected": _fc_hook,
    "Convolution": _conv_hook,
    "Deconvolution": _deconv_hook,
    "BatchNorm": _bn_hook,
    "InstanceNorm": _in_hook,
    "LayerNorm": _ln_hook,
    "Embedding": _emb_hook,
    "RNN": _rnn_hook,
    "LeakyReLU": _prelu_hook,
}

_INIT_OPS = ("_zeros", "_ones", "_full")


def _partial_init_steps(plan) -> Dict[int, tuple]:
    """{step index: shape} of the init ops whose static shape has 0-dims."""
    return {si: tuple(int(d) for d in s.params["shape"])
            for si, s in enumerate(plan.steps)
            if s.op.name in _INIT_OPS and s.params.get("shape") is not None
            and any(int(d) == 0 for d in s.params["shape"])}


class _Step:
    __slots__ = ("node", "op", "params", "in_refs", "fills_ctx",
                 "aux_var_names")

    def __init__(self, node, op, params, in_refs, aux_var_names):
        self.node = node
        self.op = op
        self.params = params      # normalized dict (without __is_train__)
        self.in_refs = in_refs    # ('var', name) | ('val', (step, out_idx))
        # position among the op's aux inputs -> the variable feeding it
        self.aux_var_names = aux_var_names
        # a creation op (no input tensor) with no ctx takes the run's device
        self.fills_ctx = (not in_refs and "ctx" in op.schema.args
                          and params.get("ctx") is None)


class GraphPlan:
    """Topologically-ordered executable plan for a Symbol."""

    def __init__(self, symbol: Symbol):
        self.symbol = symbol
        nodes = symbol._topo()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.input_names = set(self.arg_names) | set(self.aux_names)
        node_out: Dict[int, tuple] = {}
        self.steps: List[_Step] = []
        for n in nodes:
            if n.is_var:
                node_out[id(n)] = ("var", n.name)
                continue
            op = _reg.get_op(n.op)
            params = dict(op.normalize(_canon_params(op, n, len(n.inputs))))
            in_refs = []
            for src, oi in n.inputs:
                ref = node_out[id(src)]
                in_refs.append(ref if ref[0] == "var"
                               else ("val", (ref[1], oi)))
            aux_map = {pos: n.inputs[ai][0].name
                       for pos, ai in enumerate(op.aux_inputs)
                       if ai < len(n.inputs) and n.inputs[ai][0].is_var}
            node_out[id(n)] = ("step", len(self.steps))
            self.steps.append(_Step(n, op, params, in_refs, aux_map))
        self.out_refs = []
        for node, oi in symbol._entries:
            ref = node_out[id(node)]
            self.out_refs.append(("var", node.name) if ref[0] == "var"
                                 else ("val", (ref[1], oi)))

    running: Optional[int] = None

    def specialize_init_shapes(self, known_shapes: Dict[str, tuple]) -> None:
        """Resolve the 0-dims of init ops' shapes (an ``mx.rnn`` begin
        state) against the bound argument shapes, in place."""
        if not known_shapes or not _partial_init_steps(self):
            return
        try:
            plan2, _, _ = infer_shapes_types(
                self.symbol, {k: tuple(v) for k, v in known_shapes.items()
                              if v is not None}, {})
        except MXNetError:
            return
        for si, p in getattr(plan2, "init_overrides", {}).items():
            self.steps[si].params.update(p)

    def run(self, arg_values: Dict[str, torch.Tensor],
            aux_values: Optional[Dict[str, torch.Tensor]] = None,
            is_train: bool = False, segments: int = 1,
            step_overrides: Optional[Dict[int, Callable]] = None):
        """Execute the graph on ``arg_values`` and ``aux_values`` ({name:
        tensor}).  Returns (outputs, aux values): a step's trailing aux
        outputs (BatchNorm's updated moving statistics, which differ from
        its inputs only in train mode) replace the values of the variables
        that fed them, and later steps read the new values.  Creation ops
        with no ``ctx`` make their result on the device of the first
        argument.  ``segments`` > 1 runs the steps in that many
        checkpointed segments (module docstring), unless
        ``step_overrides`` replace some steps' ops."""
        aux_values = dict(aux_values or {})
        device = next((v.device for v in arg_values.values()), None)
        if segments and segments > 1 and not step_overrides:
            return self._run_segmented(arg_values, aux_values, is_train,
                                       int(segments), device)
        values: List[tuple] = [None] * len(self.steps)

        def resolve(ref):
            if ref[0] == "var":
                return self._var(ref[1], arg_values, aux_values)
            si, oi = ref[1]
            return values[si][oi]

        with _metrics.dispatch_unit("graph"):
            for si, step in enumerate(self.steps):
                self.running = si
                ins = [resolve(r) for r in step.in_refs]
                over = step_overrides.get(si) if step_overrides else None
                if _introspect.ENABLED:
                    with _introspect.layer_scope(step.node.name) as sc:
                        values[si] = sc.tag(self._call(
                            step, ins, is_train, device, aux_values, over))
                else:
                    values[si] = self._call(step, ins, is_train, device,
                                            aux_values, over)
        self.running = None
        return [resolve(r) for r in self.out_refs], aux_values

    @staticmethod
    def _var(nm, arg_values, aux_values):
        if nm in arg_values:
            return arg_values[nm]
        if nm in aux_values:
            return aux_values[nm]
        raise MXNetError(f"unbound variable '{nm}'")

    @staticmethod
    def _call(step, ins, is_train, device, aux_values, override=None):
        """One step: its visible outputs; its aux outputs go into
        ``aux_values`` under the variables that fed them."""
        p = dict(step.params)
        if step.op.takes_is_train:
            p["__is_train__"] = is_train
        if step.fills_ctx and device is not None:
            p["ctx"] = str(device)
        out = override(p, ins) if override is not None \
            else step.op.fn(p, *ins)
        out = out if isinstance(out, tuple) else (out,)
        n_vis = len(out) - len(step.op.aux_inputs)
        for pos, nm in step.aux_var_names.items():
            aux_values[nm] = out[n_vis + pos]
        return out[:n_vis]

    def _segment_layout(self, k: int):
        """Contiguous segments [(b0, b1, live_in_keys), ...]: live_in_keys
        are the (step, output) values made before b0 and read at or after
        it (a consumer index of len(steps) stands for the graph's
        outputs).  Cached per k."""
        cache = self.__dict__.setdefault("_seg_cache", {})
        if k in cache:
            return cache[k]
        n = len(self.steps)
        k = max(1, min(k, n))
        bounds = sorted({int(round(i * n / k)) for i in range(k + 1)})
        consumers: Dict[tuple, list] = {}
        for si, step in enumerate(self.steps):
            for ref in step.in_refs:
                if ref[0] == "val":
                    consumers.setdefault(ref[1], []).append(si)
        for ref in self.out_refs:
            if ref[0] == "val":
                consumers.setdefault(ref[1], []).append(n)
        segs = []
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            live_in = sorted(key for key, cs in consumers.items()
                             if key[0] < b0 and any(c >= b0 for c in cs))
            segs.append((b0, b1, live_in))
        cache[k] = segs
        return segs

    def _run_segmented(self, arg_values, aux_values, is_train, k, device):
        segs = self._segment_layout(k)
        gen = _random.generator(device) if device is not None \
            and device.type != "meta" else None

        def make_seg(b0, b1, live_out_keys):
            first_state = []

            def seg(live_in, aux_in):
                if gen is not None and first_state:
                    # recomputation: the first run's draws again
                    now = gen.get_state()
                    gen.set_state(first_state[0])
                    try:
                        return body(live_in, aux_in)
                    finally:
                        gen.set_state(now)
                if gen is not None:
                    first_state.append(gen.get_state())
                return body(live_in, aux_in)

            def body(live_in, aux_in):
                local = dict(live_in)
                aux = dict(aux_in)
                for si in range(b0, b1):
                    step = self.steps[si]
                    ins = [self._var(r[1], arg_values, aux) if r[0] == "var"
                           else local[r[1]] for r in step.in_refs]
                    if _introspect.ENABLED:
                        with _introspect.layer_scope(step.node.name) as sc:
                            out = sc.tag(self._call(step, ins, is_train,
                                                    device, aux))
                    else:
                        out = self._call(step, ins, is_train, device, aux)
                    for oi, v in enumerate(out):
                        local[(si, oi)] = v
                return {kk: local[kk] for kk in live_out_keys}, aux
            return seg

        out_keys = sorted({ref[1] for ref in self.out_refs
                           if ref[0] == "val"})
        live: Dict[tuple, torch.Tensor] = {}
        aux = aux_values
        with _metrics.dispatch_unit("graph"):
            for i, (b0, b1, _) in enumerate(segs):
                nxt = segs[i + 1][2] if i + 1 < len(segs) else out_keys
                live, aux = torch.utils.checkpoint.checkpoint(
                    make_seg(b0, b1, nxt), live, aux, use_reentrant=False,
                    preserve_rng_state=True)
        return [self._var(r[1], arg_values, aux) if r[0] == "var"
                else live[r[1]] for r in self.out_refs], aux


def _canon_params(op, node, n_inputs):
    p = {k: v for k, v in node.params.items() if k in op.schema.args}
    if op.variadic and "num_args" in op.schema.args:
        p["num_args"] = n_inputs
    return p


# ---------------------------------------------------------------------------
# shape / type inference
# ---------------------------------------------------------------------------
def meta_tensor(shape, dtype) -> torch.Tensor:
    """A tensor with shape and dtype and no data (``torch.device("meta")``):
    what shape inference feeds the ops."""
    return torch.empty(tuple(int(d) for d in shape),
                       dtype=torch_dtype(dtype), device="meta")


def _node_eval_shape(step, params, in_structs):
    p = dict(params)
    if step.op.takes_is_train:
        p["__is_train__"] = False
    if step.fills_ctx:
        p["ctx"] = "meta"
    out = step.op.fn(p, *in_structs)
    return out if isinstance(out, tuple) else (out,)


def infer_shapes_types(symbol: Symbol, known_shapes: Dict[str, tuple],
                       known_types: Dict[str, object], partial: bool = False):
    """Returns (plan, {input_name: meta tensor or None}, [meta tensor per
    output]).

    Variables carrying a partial ``__shape__`` hint with 0-dims (the
    reference's "unknown dim" convention, as deferred gluon parameters
    write it) are resolved by candidate substitution: each dim of the
    known input shapes is tried for the 0s; a wrong candidate fails at the
    first op whose shapes disagree, the right one completes inference.
    When none does, the parameter-shape hooks fill them."""
    plan = GraphPlan(symbol)
    info: Dict[str, Optional[torch.Tensor]] = {}
    partial_hints: Dict[str, tuple] = {}
    hints = {n.name: n.attrs["__shape__"] for n in symbol._topo()
             if n.is_var and "__shape__" in n.attrs}
    for nm in plan.input_names:
        shp = known_shapes.get(nm)
        dt = known_types.get(nm, _np.float32)
        if shp is None and nm in hints:
            shp = ast.literal_eval(hints[nm])   # a literal, never code
        if shp is not None and any(int(d) == 0 for d in shp):
            partial_hints[nm] = tuple(int(d) for d in shp)
            shp = None  # 0-dims mean "unknown" until substitution
        info[nm] = None if shp is None else meta_tensor(shp, np_dtype(dt))
    partial_steps = _partial_init_steps(plan)

    if (partial_hints or partial_steps) and known_shapes:
        candidates: List[int] = []
        for s in known_shapes.values():
            for d in s:
                if int(d) > 0 and int(d) not in candidates:
                    candidates.append(int(d))
        # 1 broadcasts against everything, so it can never fail; try it
        # only after every stricter candidate has been rejected
        if 1 in candidates:
            candidates.remove(1)
            candidates.append(1)
        for c in candidates:
            trial = dict(info)
            for nm, hint in partial_hints.items():
                if trial.get(nm) is None:
                    trial[nm] = meta_tensor(
                        tuple(c if d == 0 else d for d in hint),
                        np_dtype(known_types.get(nm, _np.float32)))
            overrides = {si: {"shape": tuple(c if d == 0 else d
                                             for d in hint)}
                         for si, hint in partial_steps.items()}
            try:
                res = _infer_forward(plan, trial, partial=False,
                                     overrides=overrides)
            except MXNetError:
                continue
            # the winning substitution sizes the init ops of this plan
            plan.init_overrides = overrides
            for si, p in overrides.items():
                plan.steps[si].params.update(p)
            return res
    return _infer_forward(plan, info, partial=partial)


def _infer_forward(plan, info, partial, overrides=None):
    step_out: List[Optional[tuple]] = [None] * len(plan.steps)

    def ref_struct(ref):
        if ref[0] == "var":
            return info.get(ref[1])
        si, oi = ref[1]
        return step_out[si][oi] if step_out[si] is not None else None

    for si, step in enumerate(plan.steps):
        structs = [ref_struct(r) for r in step.in_refs]
        if any(s is None for s in structs):
            hook = PARAM_SHAPE_HOOKS.get(step.op.name)
            if hook is not None and structs[0] is not None:
                fills = hook(step.params, [None if s is None else s.shape
                                           for s in structs])
                for idx, shp in fills.items():
                    ref = step.in_refs[idx] if idx < len(structs) else None
                    if ref is not None and structs[idx] is None \
                            and ref[0] == "var":
                        st = meta_tensor(shp, structs[0].dtype)
                        info[ref[1]] = st
                        structs[idx] = st
        if any(s is None for s in structs):
            if partial:
                continue
            missing = [step.in_refs[i] for i, s in enumerate(structs)
                       if s is None]
            raise MXNetError(
                f"infer_shape: cannot infer input(s) {missing} of node "
                f"'{step.node.name}' ({step.op.name}); provide their shapes")
        try:
            p = step.params
            if overrides and si in overrides:
                p = {**p, **overrides[si]}
            step_out[si] = _node_eval_shape(step, p, structs)
        except Exception as e:  # a shape error inside the op
            raise MXNetError(f"infer_shape failed at node '{step.node.name}' "
                             f"({step.op.name}): {e}") from None
    return plan, info, [ref_struct(ref) for ref in plan.out_refs]


def infer_shape(symbol: Symbol, partial: bool, *args, **kwargs):
    known = {}
    arg_names = symbol.list_arguments()
    for nm, shp in zip(arg_names, args):
        if shp is not None:
            known[nm] = shp
    known.update({k: v for k, v in kwargs.items() if v is not None})
    try:
        _, info, outs = infer_shapes_types(symbol, known, {}, partial=partial)
    except MXNetError:
        if partial:
            return None, None, None
        raise
    arg_shapes = [tuple(info[n].shape) if info.get(n) is not None else None
                  for n in arg_names]
    aux_shapes = [tuple(info[n].shape) if info.get(n) is not None else None
                  for n in symbol.list_auxiliary_states()]
    out_shapes = [tuple(o.shape) if o is not None else None for o in outs]
    return arg_shapes, out_shapes, aux_shapes


def _f32_forced_vars(symbol: Symbol):
    """Variables that stay float32 under reduced precision: the inputs an
    op declares in ``Operator.f32_inputs`` (token ids, positions)."""
    plan = GraphPlan(symbol)
    forced = set()
    for step in plan.steps:
        for i in step.op.f32_inputs:
            if i < len(step.in_refs) and step.in_refs[i][0] == "var":
                forced.add(step.in_refs[i][1])
    return forced


def infer_type(symbol: Symbol, *args, **kwargs):
    """Reference-style propagation: unknown float variables take the
    first known float dtype of a variable that is not float32-forced, in
    argument order (bfloat16 weights imply bfloat16 for the others); the
    float32-forced inputs (``_f32_forced_vars``) stay float32.

    A variable the caller gives no dtype is known by its ``__dtype__``
    attribute when that is not float32 (the reference's InferType reads
    the attribute; a cast Gluon block's parameters carry bfloat16 there),
    so a bfloat16 language model binds bfloat16 weights behind float32
    token ids.  The JAX package reads no ``__dtype__``; a float32 one is
    the default every parameter writes, and is left out here too, so
    bfloat16 data still makes such weights bfloat16."""
    known_t = {}
    arg_names = symbol.list_arguments()
    for n in symbol._topo():
        hint = n.attrs.get("__dtype__") if n.is_var else None
        if hint and np_dtype(hint) != _np.float32:
            known_t[n.name] = hint
    for nm, dt in zip(arg_names, args):
        if dt is not None:
            known_t[nm] = dt
    known_t.update({k: v for k, v in kwargs.items() if v is not None})
    forced = _f32_forced_vars(symbol)
    float_default = _np.dtype(_np.float32)
    for nm in arg_names:
        dt = known_t.get(nm)
        if dt is None or nm in forced:
            continue
        if torch_dtype(dt).is_floating_point:
            float_default = np_dtype(dt)
            break

    def var_t(n):
        if n in known_t:
            return np_dtype(known_t[n])
        return _np.dtype(_np.float32) if n in forced else float_default

    arg_types = [var_t(n) for n in arg_names]
    aux_types = [var_t(n) for n in symbol.list_auxiliary_states()]
    out_types = [float_default] * len(symbol._entries)
    return arg_types, out_types, aux_types
