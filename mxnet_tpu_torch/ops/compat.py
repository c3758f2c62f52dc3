"""The rest of the reference's op names (parity: ``mxnet_tpu/ops/compat.py``).

1. Aliases: every name of the JAX package's ``_ALIAS_MAP`` whose target the
   port registers (``_grad_add``, the ``_linalg_*`` spellings, the dense
   ``_scatter_*`` forms, ``CuDNNBatchNorm``, ...).  ``_sparse_retain``
   waits for the sparse ops (ROADMAP.md item 6).
2. Ops: ``_identity_with_attr_like_rhs``, ``_slice_assign`` and
   ``_slice_assign_scalar`` (a functional setitem), ``_linalg_gelqf``
   (LQ through the QR of A^T) and ``_linalg_syevd`` (LAPACK's ``syevd``
   on the host, so the eigenvectors carry the JAX package's signs), and
   ``IdentityAttachKLSparseReg`` (identity forward, the KL sparsity
   penalty added in its backward, its moving average an aux state).
(``reshape_like`` is in ``matrix.py``.)
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import Arg, MXNetError
from .registry import OP_ALIASES, OP_REGISTRY, register

_ALIAS_MAP = {
    "_equal": "broadcast_equal",
    "_not_equal": "broadcast_not_equal",
    "_greater": "broadcast_greater",
    "_greater_equal": "broadcast_greater_equal",
    "_lesser": "broadcast_lesser",
    "_lesser_equal": "broadcast_lesser_equal",
    "_maximum": "broadcast_maximum",
    "_minimum": "broadcast_minimum",
    "_mod": "broadcast_mod",
    "_power": "broadcast_power",
    "_hypot": "broadcast_hypot",
    "_grad_add": "elemwise_add",
    "_linalg_gemm": "linalg_gemm",
    "_linalg_gemm2": "linalg_gemm2",
    "_linalg_potrf": "linalg_potrf",
    "_linalg_potri": "linalg_potri",
    "_linalg_trmm": "linalg_trmm",
    "_linalg_trsm": "linalg_trsm",
    "_linalg_sumlogdiag": "linalg_sumlogdiag",
    "_linalg_syrk": "linalg_syrk",
    "_sparse_retain": "sparse_retain",
    "_contrib_CTCLoss": "_contrib_ctc_loss",
    "_contrib_SparseEmbedding": "Embedding",
    "CuDNNBatchNorm": "BatchNorm",
    "_scatter_plus_scalar": "_plus_scalar",
    "_scatter_minus_scalar": "_minus_scalar",
    "_scatter_elemwise_div": "elemwise_div",
}


def register_aliases() -> None:
    """Register each alias whose target (or the target's own canonical
    name) the port has; called once every op module is imported."""
    for alias, target in _ALIAS_MAP.items():
        canon = OP_ALIASES.get(target, target)
        if canon in OP_REGISTRY:
            OP_ALIASES.setdefault(alias, canon)


@register("_identity_with_attr_like_rhs", input_names=("lhs", "rhs"))
def _identity_with_attr_like_rhs(p, lhs, rhs):
    """lhs unchanged; rhs only lends graph attributes and takes no
    gradient."""
    return lhs


def _slice_tuple(p, shape):
    begin, end = p["begin"], p["end"]
    step = p.get("step") or ()
    out = []
    for i in range(len(shape)):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) else None
        out.append(slice(b, e, s))
    return tuple(out)


@register("_slice_assign", input_names=("lhs", "rhs"),
          aliases=("_crop_assign",),
          args=[Arg("begin", "shape", required=True),
                Arg("end", "shape", required=True),
                Arg("step", "shape", ())])
def _slice_assign(p, lhs, rhs):
    """A copy of lhs with the region ``begin:end:step`` replaced by rhs."""
    out = lhs.clone()
    out[_slice_tuple(p, lhs.shape)] = rhs.to(lhs.dtype)
    return out


@register("_slice_assign_scalar", input_names=("lhs",),
          aliases=("_crop_assign_scalar",),
          args=[Arg("scalar", float, 0.0),
                Arg("begin", "shape", required=True),
                Arg("end", "shape", required=True),
                Arg("step", "shape", ())])
def _slice_assign_scalar(p, lhs):
    out = lhs.clone()
    out[_slice_tuple(p, lhs.shape)] = p["scalar"]
    return out


@register("_linalg_gelqf", input_names=("A",), aliases=("linalg_gelqf",),
          num_outputs=2)
def _linalg_gelqf(p, a):
    """LQ factorization A = L Q, Q's rows orthonormal, from the QR of A^T
    (``A^T = Q1 R1``, so ``L = R1^T``, ``Q = Q1^T``).  torch's QR, as
    LAPACK's ``geqrf`` that the JAX package's runs, gives R a diagonal of
    Householder signs; returns (L, Q) as the JAX op does."""
    q1, r1 = torch.linalg.qr(a.transpose(-1, -2))
    return r1.transpose(-1, -2), q1.transpose(-1, -2)


def _syevd_host(a):
    """LAPACK's ``syevd`` over the lower triangle of each matrix of ``a``,
    run on the host: (V with eigenvectors as columns, eigenvalues)."""
    try:
        from scipy.linalg import lapack
    except ImportError as e:  # pragma: no cover - scipy is a dependency
        raise MXNetError("_linalg_syevd needs scipy's LAPACK") from e
    n = a.shape[-1]
    f64 = a.dtype == torch.float64
    solver, np_dt = (lapack.dsyevd, _np.float64) if f64 else \
        (lapack.ssyevd, _np.float32)
    flat = a.detach().to("cpu", torch.float64 if f64 else torch.float32)
    flat = flat.reshape(-1, n, n).numpy()
    vecs = _np.empty(flat.shape, np_dt)
    vals = _np.empty(flat.shape[:2], np_dt)
    for i in range(flat.shape[0]):
        w, v, info = solver(flat[i], lower=1)
        if info != 0:
            raise MXNetError(f"_linalg_syevd: LAPACK syevd info={info}")
        vals[i], vecs[i] = w, v
    return (torch.from_numpy(vecs).reshape(a.shape).to(a.device, a.dtype),
            torch.from_numpy(vals).reshape(a.shape[:-1]).to(a.device,
                                                           a.dtype))


class _Syevd(torch.autograd.Function):
    """(U, L) of a symmetrized A; the backward is the JAX package's
    ``eigh`` rule: V (diag(gL) + F o (V^T gV)) V^T, F_ij = 1 / (L_j -
    L_i) off the diagonal, symmetrized."""

    @staticmethod
    def forward(ctx, a):
        v, lam = _syevd_host(a)
        ctx.save_for_backward(v, lam)
        return v.transpose(-1, -2).contiguous(), lam

    @staticmethod
    def backward(ctx, g_u, g_lam):
        v, lam = ctx.saved_tensors
        vt = v.transpose(-1, -2)
        eye = torch.eye(lam.shape[-1], dtype=lam.dtype, device=lam.device)
        f = torch.reciprocal(eye + lam[..., None, :] - lam[..., :, None]) \
            - eye
        inner = torch.zeros_like(v)
        if g_u is not None:
            inner = f * (vt @ g_u.transpose(-1, -2))
        if g_lam is not None:
            inner = inner + torch.diag_embed(g_lam)
        ga = v @ inner @ vt
        return (ga + ga.transpose(-1, -2)) / 2


@register("_linalg_syevd", input_names=("A",), aliases=("linalg_syevd",),
          num_outputs=2)
def _linalg_syevd(p, a):
    """Symmetric eigendecomposition A = U^T diag(L) U, U's rows the
    eigenvectors, eigenvalues ascending, of (A + A^T) / 2 as
    ``jnp.linalg.eigh`` takes it.  An eigenvector's sign is the solver's
    choice: the JAX package's CPU path calls LAPACK's ``syevd`` over the
    lower triangle and torch's solvers choose other signs, so the port runs
    that same routine (scipy's LAPACK) on the host and copies the result
    back to ``a``'s device."""
    if a.device.type == "meta":
        return (torch.empty(a.shape, dtype=a.dtype, device="meta"),
                torch.empty(a.shape[:-1], dtype=a.dtype, device="meta"))
    return _Syevd.apply((a + a.transpose(-1, -2)) / 2)


class _KLSparseReg(torch.autograd.Function):
    """Identity whose backward adds penalty * (-rho/rho_hat + (1 - rho) /
    (1 - rho_hat)) to every row's gradient, rho_hat the moving average
    clipped to [1e-6, 1 - 1e-6]."""

    @staticmethod
    def forward(ctx, x, avg, rho, penalty):
        ctx.save_for_backward(avg)
        ctx.rho, ctx.penalty = rho, penalty
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (avg,) = ctx.saved_tensors
        rho, pen = ctx.rho, ctx.penalty
        rho_hat = torch.clamp(avg, 1e-6, 1 - 1e-6)[None, :]
        extra = pen * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + extra.expand(g.shape).to(g.dtype), None, None, None


@register("IdentityAttachKLSparseReg", input_names=("data", "moving_avg"),
          aux_inputs=[1],
          args=[Arg("sparseness_target", float, 0.1),
                Arg("penalty", float, 0.001),
                Arg("momentum", float, 0.9)])
def _identity_attach_kl_sparse_reg(p, x, moving_avg=None):
    """Identity forward; the backward adds the KL-divergence sparsity
    penalty's gradient against rho_hat, the momentum moving average of the
    per-unit batch mean (the new average is the aux output, as the JAX
    op's)."""
    mom = p["momentum"]
    batch_mean = torch.mean(x.detach(), dim=0)
    new_avg = batch_mean if moving_avg is None else \
        mom * moving_avg.detach() + (1 - mom) * batch_mean
    if x.device.type == "meta":
        return torch.empty_like(x), new_avg
    return (_KLSparseReg.apply(x, new_avg, p["sparseness_target"],
                               p["penalty"]), new_avg)
