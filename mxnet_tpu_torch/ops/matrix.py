"""Shape and indexing operators of the serving slice.

The counterpart of part of ``mxnet_tpu/ops/matrix.py``: ``Reshape`` with
MXNet's special codes, ``reshape_like`` (from ``mxnet_tpu/ops/compat.py``),
``expand_dims``, ``slice_axis``, ``Flatten``, ``Concat``,
``broadcast_like``, ``tile``, ``repeat``, ``where``, ``take``, ``pick``,
``Embedding`` and ``one_hot``.
Ids arrive as float32 (MXNet's convention) and are truncated to integers.
``take``, ``pick`` and ``Embedding`` clamp out-of-range ids into range, as
``jnp.take(mode="clip")`` does; torch indexing would raise on them
instead.
"""
from __future__ import annotations

import torch

from ..base import Arg, MXNetError, torch_dtype
from .registry import register


def infer_reshape(shape, src_shape):
    """MXNet Reshape special codes (parity: matrix_op-inl.h ReshapeParam):
    0 = copy this dim; -1 = infer; -2 = copy all remaining dims;
    -3 = merge next two src dims; -4 = split one src dim by the next two
    target entries."""
    src = list(src_shape)
    out = []
    i = 0  # position in src
    j = 0  # position in shape spec
    spec = list(shape)
    while j < len(spec):
        s = spec[j]
        if s > 0:
            out.append(s)
            i += 1
        elif s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            j += 2
            i += 1
        else:
            raise MXNetError(f"bad reshape code {s}")
        j += 1
    if out.count(-1) > 1:
        raise MXNetError("only one -1 allowed in reshape")
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in src:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", input_names=("data",), aliases=("reshape",),
          args=[Arg("shape", "shape", ()), Arg("reverse", bool, False)])
def _reshape(p, x):
    return torch.reshape(x, infer_reshape(p["shape"], x.shape))


@register("reshape_like", input_names=("lhs", "rhs"))
def _reshape_like(p, lhs, rhs):
    """lhs reshaped to rhs's shape (the gradient flows to lhs only)."""
    return lhs.reshape(rhs.shape)


@register("expand_dims", input_names=("data",), args=[Arg("axis", int, required=True)])
def _expand_dims(p, x):
    return torch.unsqueeze(x, p["axis"])


@register("slice_axis", input_names=("data",),
          args=[Arg("axis", int, required=True), Arg("begin", int, required=True),
                Arg("end", int, None)])
def _slice_axis(p, x):
    ax = p["axis"] % x.dim()
    idx = [slice(None)] * x.dim()
    idx[ax] = slice(p["begin"], p["end"])
    return x[tuple(idx)]


@register("Flatten", input_names=("data",), aliases=("flatten",))
def _flatten(p, x):
    """(N, ...) to (N, product of the rest)."""
    return x.reshape(x.shape[0], -1)


@register("Concat", input_names=("args",), variadic=True, aliases=("concat",),
          args=[Arg("dim", int, 1), Arg("num_args", int, 0)])
def _concat(p, *xs):
    return torch.cat(xs, dim=p["dim"])


@register("broadcast_like", input_names=("lhs", "rhs"))
def _broadcast_like(p, x, y):
    return x.expand(y.shape)


@register("tile", input_names=("data",), args=[Arg("reps", "shape", required=True)])
def _tile(p, x):
    return torch.tile(x, p["reps"])


@register("repeat", input_names=("data",),
          args=[Arg("repeats", int, required=True), Arg("axis", int, None)])
def _repeat(p, x):
    """Each element ``repeats`` times along ``axis``; with no axis, over the
    flattened input (as ``jnp.repeat``)."""
    return torch.repeat_interleave(x, p["repeats"], dim=p["axis"])


@register("where", input_names=("condition", "x", "y"))
def _where(p, c, x, y):
    return torch.where(c if c.dtype == torch.bool else c != 0, x, y)


def _ids(idx):
    return idx.to(torch.int64)


def _take_rows(a, idx, axis):
    """a's slices along ``axis`` at the (already in-range) int ids."""
    axis = axis % a.dim()
    flat = torch.index_select(a, axis, idx.reshape(-1))
    return flat.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("take", input_names=("a", "indices"), f32_inputs=(1,),
          args=[Arg("axis", int, 0), Arg("mode", str, "clip")])
def _take(p, a, idx):
    # 'wrap' takes the ids modulo the axis; 'raise' clips, as in the JAX
    # package (no data-dependent error on device)
    if p["mode"] not in ("clip", "raise", "wrap"):
        raise MXNetError(f"take: mode {p['mode']!r} is not one of 'clip', "
                         "'wrap', 'raise'")
    n = a.shape[p["axis"]]
    ids = torch.remainder(_ids(idx), n) if p["mode"] == "wrap" \
        else torch.clamp(_ids(idx), 0, n - 1)
    return _take_rows(a, ids, p["axis"])


@register("pick", input_names=("data", "index"), f32_inputs=(1,),
          args=[Arg("axis", int, -1), Arg("keepdims", bool, False),
                Arg("mode", str, "clip")])
def _pick(p, x, idx):
    """x's entries at ``index`` along ``axis`` (index shaped like x without
    that axis); ids clamp into range whatever ``mode`` says, as in the
    JAX package."""
    ax = p["axis"] % x.dim()
    ids = torch.clamp(_ids(idx), 0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(x, ax, ids)
    return out if p["keepdims"] else out.squeeze(ax)


@register("Embedding", input_names=("data", "weight"), f32_inputs=(0,),
          args=[Arg("input_dim", int, required=True), Arg("output_dim", int, required=True),
                Arg("dtype", str, "float32"), Arg("sparse_grad", bool, False)])
def _embedding(p, data, weight):
    """Embedding lookup; out-of-range ids clamp to the first/last row."""
    ids = torch.clamp(_ids(data), 0, weight.shape[0] - 1)
    return _take_rows(weight, ids, 0)


@register("one_hot", input_names=("indices",), f32_inputs=(0,),
          args=[Arg("depth", int, required=True), Arg("on_value", float, 1.0),
                Arg("off_value", float, 0.0), Arg("dtype", str, "float32")],
          differentiable=False)
def _one_hot(p, idx):
    """Out-of-range ids give an all-off row, as ``jax.nn.one_hot`` does."""
    depth = torch.arange(p["depth"], device=idx.device)
    oh = (_ids(idx)[..., None] == depth).to(torch.float32)
    out = oh * (p["on_value"] - p["off_value"]) + p["off_value"]
    return out.to(torch_dtype(p["dtype"]))
