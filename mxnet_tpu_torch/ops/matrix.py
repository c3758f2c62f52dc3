"""Shape, layout, indexing and linear-algebra operators.

The counterpart of ``mxnet_tpu/ops/matrix.py``: ``Reshape`` with MXNet's
special codes, ``reshape_like`` (from ``mxnet_tpu/ops/compat.py``),
``transpose``, ``SwapAxis``, ``expand_dims``, ``squeeze``, the slice
family (``slice``, ``slice_axis``, ``slice_like``, ``SliceChannel``),
``Flatten``, ``Concat``, ``stack``, ``broadcast_to``/``_axis``/``_like``,
``tile``, ``repeat``, ``reverse``, ``Pad``, ``zeros_like``/``ones_like``,
``where``, ``dot``/``batch_dot``, ``take``, ``batch_take``, ``pick``,
``Embedding``, ``one_hot``, ``gather_nd``/``scatter_nd`` and the
``linalg_*`` ops, which batch over leading axes.
Ids arrive as float32 (MXNet's convention) and are truncated to integers.
``take``, ``pick``, ``batch_take`` and ``Embedding`` clamp out-of-range ids
into range, as ``jnp.take(mode="clip")`` does; torch indexing would raise
on them instead.  Layout ops return views where torch can (``transpose``
and the slices, as ``slice_axis`` always has): a kernel that needs
contiguous memory copies at its own call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


@register("transpose", input_names=("data",), args=[Arg("axes", "shape", ())])
def _transpose(p, x):
    """The axes permuted as ``axes`` says; none reverses them."""
    return x.permute(p["axes"] or tuple(range(x.dim() - 1, -1, -1)))


@register("SwapAxis", input_names=("data",), aliases=("swapaxes",),
          args=[Arg("dim1", int, 0), Arg("dim2", int, 0)])
def _swapaxes(p, x):
    return torch.swapaxes(x, p["dim1"], p["dim2"])


@register("expand_dims", input_names=("data",), args=[Arg("axis", int, required=True)])
def _expand_dims(p, x):
    return torch.unsqueeze(x, p["axis"])


@register("squeeze", input_names=("data",), args=[Arg("axis", "shape", None)])
def _squeeze(p, x):
    """Drop the given axes (of size 1), or every axis of size 1."""
    ax = p["axis"]
    return torch.squeeze(x, dim=tuple(a % x.dim() for a in ax)) if ax \
        else torch.squeeze(x)


def _canon_slice(begin, end, step, shape):
    """MXNet slice params (None and negative entries) as concrete python
    slices, one per axis."""
    step = step or (1,) * len(begin)
    out = []
    for ax, n in enumerate(shape):
        if ax < len(begin):
            b = begin[ax]
            e = end[ax] if ax < len(end) else None
            s = step[ax] if ax < len(step) else 1
        else:
            b, e, s = None, None, 1
        out.append(slice(*slice(b, e, 1 if s in (None, 0) else s).indices(n)))
    return tuple(out)


def _slice_steps(x, slices):
    """x[slices] for python slices whose steps may be negative (torch
    indexing takes positive steps only): a negative step flips the axis
    and slices it forwards."""
    for ax, sl in enumerate(slices):
        if sl.step < 0:
            n = x.shape[ax]
            x = torch.flip(x, dims=(ax,))
            start, stop = n - 1 - sl.start, n - 1 - sl.stop
            slices = slices[:ax] + (slice(start, max(stop, start), -sl.step),) \
                + slices[ax + 1:]
    return x[slices]


@register("slice", input_names=("data",), aliases=("crop",),
          args=[Arg("begin", "shape", required=True),
                Arg("end", "shape", required=True), Arg("step", "shape", None)])
def _slice(p, x):
    return _slice_steps(x, _canon_slice(p["begin"], p["end"], p["step"],
                                        x.shape))


@register("slice_like", input_names=("data", "shape_like"),
          args=[Arg("axes", "shape", ())])
def _slice_like(p, x, y):
    """The leading part of x shaped like y on ``axes`` (every shared axis
    when none are given)."""
    axes = p["axes"] or tuple(range(min(x.dim(), y.dim())))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a % x.dim()] = slice(0, y.shape[a % x.dim()])
    return x[tuple(idx)]


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


@register("stack", input_names=("args",), variadic=True,
          args=[Arg("axis", int, 0), Arg("num_args", int, 0)])
def _stack(p, *xs):
    return torch.stack(xs, dim=p["axis"])


@register("SliceChannel", input_names=("data",), aliases=("split",),
          args=[Arg("num_outputs", int, required=True), Arg("axis", int, 1),
                Arg("squeeze_axis", bool, False)],
          num_outputs=-1)
def _slice_channel(p, x):
    """``num_outputs`` equal parts along ``axis`` (the axis must divide),
    each with that axis dropped under ``squeeze_axis``."""
    n, ax = p["num_outputs"], p["axis"]
    if x.shape[ax] % n:
        raise MXNetError(f"SliceChannel: axis {ax} of {tuple(x.shape)} does "
                         f"not split into {n} equal parts")
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if p["squeeze_axis"]:
        parts = [t.squeeze(ax) for t in parts]
    return tuple(parts)


@register("broadcast_to", input_names=("data",),
          args=[Arg("shape", "shape", required=True)])
def _broadcast_to(p, x):
    """x broadcast to ``shape``; a 0 there keeps x's size on that axis."""
    return x.expand(tuple(s if s != 0 else x.shape[i]
                          for i, s in enumerate(p["shape"])))


@register("broadcast_axis", input_names=("data",), aliases=("broadcast_axes",),
          args=[Arg("axis", "shape", ()), Arg("size", "shape", ())])
def _broadcast_axis(p, x):
    tgt = list(x.shape)
    for a, n in zip(p["axis"], p["size"]):
        tgt[a % x.dim()] = n
    return x.expand(tuple(tgt))


@register("broadcast_like", input_names=("lhs", "rhs"))
def _broadcast_like(p, x, y):
    return x.expand(y.shape)


@register("reverse", input_names=("data",), aliases=("flip",),
          args=[Arg("axis", "shape", required=True)])
def _reverse(p, x):
    return torch.flip(x, dims=p["axis"])


@register("Pad", input_names=("data",), aliases=("pad",),
          args=[Arg("mode", str, "constant"),
                Arg("pad_width", "shape", required=True),
                Arg("constant_value", float, 0.0)])
def _pad(p, x):
    """``pad_width`` holds (before, after) for each axis in order, as
    ``jnp.pad`` takes them; ``F.pad`` takes the pairs last axis first.
    'edge' is ``F.pad``'s 'replicate', 'reflect' its 'reflect'."""
    pw = p["pad_width"]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if p["mode"] == "constant":
        return F.pad(x, [n for pair in reversed(pairs) for n in pair],
                     mode="constant", value=p["constant_value"])
    # F.pad's other modes pad the axes after the first two, as MXNet's Pad
    # does for them
    if any(n for pair in pairs[:2] for n in pair):
        raise MXNetError(f"Pad: mode {p['mode']!r} pads the axes after the "
                         f"first two only, got pad_width {pw}")
    mode = {"edge": "replicate", "reflect": "reflect"}[p["mode"]]
    return F.pad(x, [n for pair in reversed(pairs[2:]) for n in pair],
                 mode=mode)


@register("zeros_like", input_names=("data",))
def _zeros_like(p, x):
    return torch.zeros_like(x)


@register("ones_like", input_names=("data",))
def _ones_like(p, x):
    return torch.ones_like(x)


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


def _t(x):
    """The last two axes swapped (a 1-D input as it is)."""
    return x.transpose(-1, -2) if x.dim() >= 2 else x


@register("dot", input_names=("lhs", "rhs"),
          args=[Arg("transpose_a", bool, False), Arg("transpose_b", bool, False)])
def _dot(p, a, b):
    """Parity: src/operator/tensor/dot-inl.h (dense path), as the JAX
    package computes it: inputs of at most 2 axes multiply as matrices,
    others contract lhs's last axis with rhs's first (``tensordot``).
    ``transpose_a`` on an N-d lhs moves its last axis to the front and
    ``transpose_b`` on an N-d rhs its first axis to the back, as the JAX
    package does (upstream MXNet contracts over lhs's first axis)."""
    if p["transpose_a"]:
        a = torch.movedim(a, -1, 0) if a.dim() > 2 else _t(a)
    if p["transpose_b"]:
        b = torch.movedim(b, 0, -1) if b.dim() > 2 else _t(b)
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot", input_names=("lhs", "rhs"),
          args=[Arg("transpose_a", bool, False), Arg("transpose_b", bool, False)])
def _batch_dot(p, a, b):
    if p["transpose_a"]:
        a = a.transpose(-1, -2)
    if p["transpose_b"]:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


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


@register("batch_take", input_names=("a", "indices"), f32_inputs=(1,))
def _batch_take(p, a, idx):
    """Row i's entry at column indices[i] of a (N, M) input, clamped."""
    ids = torch.clamp(_ids(idx), 0, a.shape[1] - 1)
    return torch.gather(a, 1, ids.reshape(-1, 1))[:, 0]


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


@register("gather_nd", input_names=("data", "indices"), f32_inputs=(1,))
def _gather_nd(p, data, indices):
    """data at the (M, ...) index tuples of ``indices``: its first axis
    indexes data's first M axes.  Negative ids count from the end, as
    numpy indexing does (torch's too)."""
    idx = _ids(indices)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd", input_names=("data", "indices"),
          args=[Arg("shape", "shape", required=True)])
def _scatter_nd(p, data, indices):
    """A zero tensor of ``shape`` with data added at ``indices`` (the
    inverse of ``gather_nd``; repeated index tuples add up)."""
    idx = _ids(indices)
    out = torch.zeros(p["shape"], dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data,
                         accumulate=True)


# ---------------------------------------------------------------------------
# Linear algebra (parity: src/operator/tensor/la_op.cc, the JAX package's
# subset); every op batches over the leading axes
# ---------------------------------------------------------------------------
@register("linalg_gemm", input_names=("A", "B", "C"),
          args=[Arg("transpose_a", bool, False), Arg("transpose_b", bool, False),
                Arg("alpha", float, 1.0), Arg("beta", float, 1.0)])
def _linalg_gemm(p, a, b, c):
    """alpha * op(A) op(B) + beta * C."""
    a = a.transpose(-1, -2) if p["transpose_a"] else a
    b = b.transpose(-1, -2) if p["transpose_b"] else b
    return p["alpha"] * torch.matmul(a, b) + p["beta"] * c


@register("linalg_gemm2", input_names=("A", "B"),
          args=[Arg("transpose_a", bool, False), Arg("transpose_b", bool, False),
                Arg("alpha", float, 1.0)])
def _linalg_gemm2(p, a, b):
    a = a.transpose(-1, -2) if p["transpose_a"] else a
    b = b.transpose(-1, -2) if p["transpose_b"] else b
    return p["alpha"] * torch.matmul(a, b)


@register("linalg_potrf", input_names=("A",))
def _linalg_potrf(p, a):
    """The lower Cholesky factor of a symmetric positive definite A."""
    return torch.linalg.cholesky(a)


@register("linalg_potri", input_names=("A",))
def _linalg_potri(p, a):
    """The inverse of L L^T from its lower Cholesky factor L (the JAX
    package's ``cho_solve`` against the identity).  Only L's lower triangle
    is read, so only it takes a gradient, as in the JAX package."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.cholesky_solve(eye.expand(a.shape), torch.tril(a))


@register("linalg_trsm", input_names=("A", "B"),
          args=[Arg("transpose", bool, False), Arg("rightside", bool, False),
                Arg("alpha", float, 1.0), Arg("lower", bool, True)])
def _linalg_trsm(p, a, b):
    """alpha * op(A)^-1 B, or alpha * B op(A)^-1 with ``rightside``, for a
    triangular A (``lower`` says which half)."""
    lower = p["lower"]
    if p["transpose"]:
        a, lower = a.transpose(-1, -2), not lower
    out = torch.linalg.solve_triangular(a, b, upper=not lower,
                                        left=not p["rightside"])
    return p["alpha"] * out


@register("linalg_trmm", input_names=("A", "B"),
          args=[Arg("transpose", bool, False), Arg("rightside", bool, False),
                Arg("alpha", float, 1.0), Arg("lower", bool, True)])
def _linalg_trmm(p, a, b):
    """alpha * op(A) B, or alpha * B op(A) with ``rightside``, for the
    triangle of A that ``lower`` names."""
    tri = torch.tril(a) if p["lower"] else torch.triu(a)
    if p["transpose"]:
        tri = tri.transpose(-1, -2)
    out = torch.matmul(b, tri) if p["rightside"] else torch.matmul(tri, b)
    return p["alpha"] * out


@register("linalg_sumlogdiag", input_names=("A",))
def _linalg_sumlogdiag(p, a):
    return torch.sum(torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_syrk", input_names=("A",),
          args=[Arg("transpose", bool, False), Arg("alpha", float, 1.0)])
def _linalg_syrk(p, a):
    """alpha * A A^T, or alpha * A^T A with ``transpose``."""
    at = a.transpose(-1, -2)
    return p["alpha"] * (torch.matmul(at, a) if p["transpose"]
                         else torch.matmul(a, at))
