"""The ``Custom`` operator: Python ops in ``nd`` calls and Symbol graphs
(parity: ``mxnet_tpu/ops/custom.py``; upstream ``custom.cc`` and
``python/mxnet/operator.py``).

A ``CustomOpProp`` registered under ``op_type`` (``mx.operator.register``)
declares the op's arguments, outputs and shapes and creates the
``CustomOp`` whose ``forward``/``backward`` compute it.  Here they run
eagerly on the port's tensors, on the op's device, inside that device's
context (so ``nd.array`` in user code lands there, as upstream hands
NDArrays on the op's context); the outputs and input gradients are
tensors the op allocates and the user writes with ``self.assign``.  The
gradient goes through a ``torch.autograd.Function``.  Forward and
backward of one node share one ``CustomOp`` instance (user ops keep
intermediates on ``self``): a Symbol node carries a unique ``__node__``
parameter, eager calls share an instance per signature, and the instance
cache is LRU-bounded.

Host code cannot be captured into a CUDA graph: ``Custom`` raises
``MXNetError`` naming its ``op_type`` inside a capture (the whole step,
the superstep, ``Module``'s fused step).  Shape inference runs the prop's
``infer_shape`` and never the user's forward.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

from ..base import Arg, MXNetError, ParamSchema, np_dtype, torch_dtype
from .registry import OP_REGISTRY, Operator

# op_type -> CustomOpProp subclass (filled by mxnet_tpu_torch.operator.register)
CUSTOM_PROP_REGISTRY: Dict[str, type] = {}

_OP_INSTANCE_CACHE: "OrderedDict" = OrderedDict()
_OP_INSTANCE_CACHE_MAX = 256


def _get_op_instance(prop, pt, shapes, dtypes):
    key = (tuple(kv for kv in pt if kv[0] != "__is_train__"),
           tuple(tuple(s) for s in shapes), tuple(str(d) for d in dtypes))
    inst = _OP_INSTANCE_CACHE.get(key)
    if inst is None:
        inst = prop.create_operator(None, [tuple(s) for s in shapes],
                                    list(dtypes))
        _OP_INSTANCE_CACHE[key] = inst
        while len(_OP_INSTANCE_CACHE) > _OP_INSTANCE_CACHE_MAX:
            _OP_INSTANCE_CACHE.popitem(last=False)
    else:
        _OP_INSTANCE_CACHE.move_to_end(key)
    return inst


def _make_prop(pd):
    op_type = pd.get("op_type")
    cls = CUSTOM_PROP_REGISTRY.get(op_type)
    if cls is None:
        raise MXNetError(
            f"Custom op_type '{op_type}' not registered; use "
            "@mx.operator.register(name) on a CustomOpProp subclass")
    prop = cls(**{k: v for k, v in pd.items()
                  if k != "op_type" and not k.startswith("__")})
    if prop.list_auxiliary_states():
        raise MXNetError(
            "Custom ops with auxiliary states are not supported (declare "
            "them as regular arguments instead)")
    return prop


def _out_specs(prop, ins):
    """[(shape, torch dtype)] of the outputs from the prop's inference."""
    out_shapes = list(prop.infer_shape([tuple(x.shape) for x in ins])[1])
    out_types = list(prop.infer_type([np_dtype(x.dtype) for x in ins])[1])
    return [(tuple(int(d) for d in s), torch_dtype(t))
            for s, t in zip(out_shapes, out_types)]


def _context(device):
    from ..context import Context
    return Context("gpu" if device.type == "cuda" else "cpu",
                   device.index or 0)


class _CustomFn(torch.autograd.Function):
    """The user's forward, and its backward as the gradient."""

    @staticmethod
    def forward(ctx, pt, n_out, *ins):
        pd = dict(pt)
        prop = _make_prop(pd)
        specs = _out_specs(prop, ins)
        dev = ins[0].device
        op = _get_op_instance(prop, pt, [x.shape for x in ins],
                              [np_dtype(x.dtype) for x in ins])
        outs = [torch.zeros(s, dtype=t, device=dev) for s, t in specs]
        with _context(dev):
            op.forward(bool(pd.get("__is_train__")), ["write"] * len(outs),
                       list(ins), outs, [])
        ctx.pt, ctx.op = pt, op
        ctx.save_for_backward(*ins, *outs)
        ctx.n_in = len(ins)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        dev = ins[0].device
        og = [torch.zeros_like(o) if g is None else g.contiguous()
              for o, g in zip(outs, grads)]
        ig = [torch.zeros_like(x) for x in ins]
        with _context(dev):
            ctx.op.backward(["write"] * len(ig), og, list(ins), list(outs),
                            ig, [])
        return (None, None) + tuple(ig)


def _capturing(ins) -> bool:
    """Whether a CUDA graph is being captured on the stream of ``ins``."""
    return any(x.device.type == "cuda" for x in ins) \
        and torch.cuda.is_current_stream_capturing()


def _custom(p, *ins):
    """Dispatch to the registered ``CustomOpProp``'s operator."""
    pd = dict(p)
    if any(x.device.type == "meta" for x in ins):
        prop = _make_prop(pd)
        outs = tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in _out_specs(prop, ins))
        return outs if len(outs) > 1 else outs[0]
    if _capturing(ins):
        raise MXNetError(
            f"Custom op '{pd.get('op_type')}' runs Python on the host and "
            "cannot be captured into a CUDA graph (whole step, superstep or "
            "MXNET_FUSED_STEP): run this net on the eager path")
    pt = tuple(sorted(p.items()))
    outs = _CustomFn.apply(pt, len(ins), *ins)
    return outs if len(outs) > 1 else outs[0]


def _custom_shape_hook(p, shapes):
    """Fill unknown input shapes (a Custom loss layer's label) from the
    prop's ``infer_shape``."""
    known = [tuple(s) if s is not None else () for s in shapes]
    try:
        corrected = list(_make_prop(dict(p)).infer_shape(list(known))[0])
    except Exception:
        return {}
    return {i: tuple(int(d) for d in corrected[i])
            for i in range(len(shapes))
            if shapes[i] is None and i < len(corrected) and corrected[i]}


def custom_num_outputs(params) -> int:
    return len(_make_prop(dict(params)).list_outputs())


OP_REGISTRY["Custom"] = Operator(
    name="Custom",
    fn=_custom,
    input_names=["args"],
    schema=ParamSchema([Arg("op_type", str, required=True)],
                       open_schema=True),
    num_outputs=-1,
    variadic=True,
    takes_is_train=True,
    docstring=_custom.__doc__ or "",
)
