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
data's trailing width, src/operator/nn/fully_connected-inl.h), for the ops
the port has.

Not ported: the channels-last layout pass (TPU only), per-layer profiler
scopes (``introspect``, ROADMAP item 5), the RNN parameter hook (item 7)
and ``segments > 1`` (rematerialised training segments, item 3).
"""
from __future__ import annotations

import ast
import math
from typing import Callable, Dict, List, Optional

import numpy as _np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..ops import registry as _reg
from .symbol import Symbol


# op name -> fn(params, in_shapes) -> {input_index: shape} for unknown-var fill
def _fc_hook(p, shp):
    d = shp[0]
    red = math.prod(d[1:]) if p.get("flatten", True) else d[-1]
    out = {1: (p["num_hidden"], red)}
    if not p.get("no_bias"):
        out[2] = (p["num_hidden"],)
    return out


def _ln_hook(p, shp):
    c = shp[0][p.get("axis", -1) % len(shp[0])]
    return {1: (c,), 2: (c,)}


def _emb_hook(p, shp):
    return {1: (p["input_dim"], p["output_dim"])}


PARAM_SHAPE_HOOKS: Dict[str, Callable] = {
    "FullyConnected": _fc_hook,
    "LayerNorm": _ln_hook,
    "Embedding": _emb_hook,
}


class _Step:
    __slots__ = ("node", "op", "params", "in_refs", "fills_ctx")

    def __init__(self, node, op, params, in_refs):
        self.node = node
        self.op = op
        self.params = params      # normalized dict (without __is_train__)
        self.in_refs = in_refs    # ('var', name) | ('val', (step, out_idx))
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
            node_out[id(n)] = ("step", len(self.steps))
            self.steps.append(_Step(n, op, params, in_refs))
        self.out_refs = []
        for node, oi in symbol._entries:
            ref = node_out[id(node)]
            self.out_refs.append(("var", node.name) if ref[0] == "var"
                                 else ("val", (ref[1], oi)))

    def run(self, arg_values: Dict[str, torch.Tensor],
            aux_values: Optional[Dict[str, torch.Tensor]] = None,
            is_train: bool = False, segments: int = 1):
        """Execute the graph on ``arg_values`` ({name: tensor}).  Returns
        (outputs, aux values).  Creation ops with no ``ctx`` make their
        result on the device of the first argument."""
        if segments and segments > 1:
            raise NotImplementedError(
                "GraphPlan.run(segments > 1) rematerialises training "
                "segments, which are not ported yet (ROADMAP.md, queue "
                "item 3: training)")
        aux_values = dict(aux_values or {})
        values: List[tuple] = [None] * len(self.steps)
        device = next((v.device for v in arg_values.values()), None)

        def resolve(ref):
            if ref[0] == "var":
                nm = ref[1]
                if nm in arg_values:
                    return arg_values[nm]
                if nm in aux_values:
                    return aux_values[nm]
                raise MXNetError(f"unbound variable '{nm}'")
            si, oi = ref[1]
            return values[si][oi]

        for si, step in enumerate(self.steps):
            ins = [resolve(r) for r in step.in_refs]
            p = dict(step.params)
            if step.op.takes_is_train:
                p["__is_train__"] = is_train
            if step.fills_ctx and device is not None:
                p["ctx"] = str(device)
            out = step.op.fn(p, *ins)
            values[si] = out if isinstance(out, tuple) else (out,)
        return [resolve(r) for r in self.out_refs], aux_values


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

    if partial_hints and known_shapes:
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
            try:
                res = _infer_forward(plan, trial, partial=False)
            except MXNetError:
                continue
            return res
    return _infer_forward(plan, info, partial=partial)


def _infer_forward(plan, info, partial):
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
            step_out[si] = _node_eval_shape(step, step.params, structs)
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
    float32-forced inputs (``_f32_forced_vars``) stay float32."""
    known_t = {}
    arg_names = symbol.list_arguments()
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
