"""Flash attention: the wrappers around its CUDA kernels, forward and
backward.

Replaces ``mxnet_tpu/ops/flash_attention.py:_flash_attention`` (the Pallas
kernel ``_fa_kernel``): O = softmax(scale * Q K^T [causal mask -1e30]) V with
an online softmax kept in float32.  Two kernels compute it, and
``_variant(dtype, head_dim)`` picks one from the input alone:

* ``"sm90"`` (``csrc/flash_attention_fwd_sm90.cu``): bfloat16 with head dim
  64 or 128, on the tensor cores (wgmma, TMA, a pipelined K/V ring).
* ``"f32"`` (``csrc/flash_attention_fwd.cu``): float32 at every head dim,
  and bfloat16 at 16 or 32, on the tensor cores in 3xTF32 form (each
  float32 product is three TF32 wgmmas over hi/lo splits of its operands,
  which keeps the f32 pin of 1e-4; plain TF32 would not).

Bound on an H100 SXM at the serving shape (B*H = 64, T = 1024, D = 64,
bf16, causal): 8.6 GFLOP is about 9 us at 989 TFLOP/s and the 33.6 MB of
q, k, v and o about 10 us at 3.35 TB/s, so the bytes bound it.  In float32
the operations bound it: 4.3 GFLOP at 165 TFLOP/s (495 / 3) is 26 us.

Both kernels also write each row's log-sum-exp when asked
(``return_lse``), which their backward reads.

The backward, ``flash_attention_bwd`` (K1b), replaces
``mxnet_tpu/ops/flash_attention.py:_fa_bwd``, the plain ``jnp`` gradient of
the Pallas forward: dq, dk and dv from q, k, v, o and dO.  ``_bwd_variant``
routes it as the forward is routed:

* ``"sm90"`` (``csrc/flash_attention_bwd_sm90.cu``): bfloat16 at head dim
  64 or 128, on the tensor cores, with the forward's row log-sum-exp.
* ``"f32"`` (``csrc/flash_attention_bwd.cu``): float32 at every head dim
  and bfloat16 at 16 or 32, 3xTF32 on the tensor cores, with the f32
  forward's row log-sum-exp.

Bound at the training shape (B*H = 128, T = 1024, D = 64, bf16, causal):
43 GFLOP (10*D per unmasked pair) is about 0.043 ms at 989 TFLOP/s, the
134 MB of q, k, v, o, dO, dq, dk and dv about 0.040 ms at 3.35 TB/s.

A CPU tensor takes the plain version (``dense_reference``,
``bwd_reference``).  A CUDA tensor launches the kernel or raises: nothing
falls back.  A meta tensor (shape inference) gets empty outputs of the
right shape.

While the program introspector counts a program (``introspect.COUNTING``)
each call books the kernel's model flops, which its dispatch mode cannot
see: 4*B*H*Tq*Tk*D forward, 8*B*H*Tq*Tk*D backward (no causal halving, no
recompute), and the inputs read and outputs written once; the plain
version's ops on the CPU are then not counted again.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from ..observability import introspect as _introspect
from . import _build

NEG_INF = -1e30
SUPPORTED_D = (16, 32, 64, 128)
SM90_D = (64, 128)
SM90_BLOCK_N = 128  # keys per k-tile of the sm90 kernel (BN in its source)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, lse (or null), bh, tq, tk, d, scale, causal, dtype (then the
# stream)
_FWD_ARGTYPES = [_P] * 5 + [_I] * 4 + [_F, _I, _I]
_ENTRIES = {
    "sm90": _build.Entry("flash_attention_fwd_sm90",
                         "mxt_flash_attention_fwd_sm90", _FWD_ARGTYPES),
    "f32": _build.Entry("flash_attention_fwd", "mxt_flash_attention_fwd",
                        _FWD_ARGTYPES),
}

# q, k, v, o, dO, dq, dk, dv, the forward's lse, a float32 scratch of two
# (bh, tq rounded up to 64) planes, bh, tq, tk, d, scale, causal, dtype
# (then the stream)
_BWD_ARGTYPES = [_P] * 10 + [_I] * 4 + [_F, _I, _I]
_BWD_ENTRIES = {
    "sm90": _build.Entry("flash_attention_bwd_sm90",
                         "mxt_flash_attention_bwd_sm90", _BWD_ARGTYPES),
    "f32": _build.Entry("flash_attention_bwd", "mxt_flash_attention_bwd",
                        _BWD_ARGTYPES),
}

# kernel launches made in this process: all of them, the forward's by
# variant, and the backward's, in all and by variant
LAUNCHES = 0
VARIANT_LAUNCHES = dict.fromkeys(_ENTRIES, 0)
BWD_LAUNCHES = 0
BWD_VARIANT_LAUNCHES = dict.fromkeys(_BWD_ENTRIES, 0)


def _scores(q, k, scale, causal):
    """float32 scale * q k^T, -1e30 above the causal diagonal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    return s


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def dense_reference(q, k, v, scale, causal, return_lse=False):
    """Plain version: float32 scores and softmax, cast back to q's dtype.
    q (B, H, Tq, D), k and v (B, H, Tk, D).  With ``return_lse`` also each
    row's log-sum-exp of the scaled, masked scores (float32 (B, H, Tq),
    natural log), as both kernels write it."""
    s = _scores(q, k, scale, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def bwd_reference(q, k, v, o, do, scale, causal, lse=None):
    """Plain version of the backward: ``_fa_bwd``'s formulas over whole
    rows, in float32, cast back to the inputs' dtypes.  Returns dq, dk, dv.
    With ``lse`` (the forward's row log-sum-exp) P is exp(s - lse), as
    both kernels compute it; without, the softmax of the scores.
    """
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    s = _scores(q, k, scale, causal)
    p = torch.softmax(s, dim=-1) if lse is None \
        else torch.exp(s - lse.float()[..., None])
    delta = torch.sum(gf * of, dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _variant(dtype, d, fn="flash_attention_fwd"):
    """The kernel for inputs of ``dtype`` and head dim ``d``: ``"sm90"`` for
    bfloat16 at D 64 or 128, ``"f32"`` for every other supported case."""
    if dtype not in _DTYPE_CODE or d not in SUPPORTED_D:
        raise MXNetError(f"{fn}: {dtype} with head dim {d} "
                         f"is not supported (float32 or bfloat16, D in "
                         f"{SUPPORTED_D})")
    return "sm90" if dtype == torch.bfloat16 and d in SM90_D else "f32"


def _bwd_variant(dtype, d):
    """The backward kernel for inputs of ``dtype`` and head dim ``d``: the
    forward's routing, so ``"sm90"`` follows the kernel that wrote lse."""
    return _variant(dtype, d, "flash_attention_bwd")


def _check(q, k, v, fn="flash_attention_fwd", **extra):
    """Refuse what the kernels do not take.  ``extra`` names further
    tensors shaped like q (the backward's o and dO)."""
    named = (("q", q), ("k", k), ("v", v)) + tuple(extra.items())
    for name, t in named:
        if t.device.type != "cuda" or t.device != q.device:
            raise MXNetError(f"{fn}: {name} is on {t.device}, q on "
                             f"{q.device}; all must be on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise MXNetError(f"{fn}: {name} is {t.dtype}; "
                             f"{', '.join(n for n, _ in named)} must all be "
                             "float32 or bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise MXNetError(f"{fn}: {name} must be a contiguous (B, H, T, "
                             f"D) tensor, got {tuple(t.shape)} with strides "
                             f"{t.stride()}")
        if t.data_ptr() % 16:
            raise MXNetError(f"{fn}: {name} is not 16-byte aligned")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or v.shape != k.shape or k.shape[3] != D or \
            any(t.shape != q.shape for t in extra.values()):
        raise MXNetError(f"{fn}: shapes " + ", ".join(
            f"{n} {tuple(t.shape)}" for n, t in named) + " disagree")
    if min(q.shape[2], k.shape[2], B * H) < 1:
        raise MXNetError(f"{fn}: empty input")


def _launch(variant, q, k, v, scale, causal, return_lse=False):
    """Check the CUDA inputs, launch kernel ``variant`` and count it.  The
    path comes here through ``flash_attention_fwd``, with the routed
    variant; a measurement may name ``"f32"`` to time that kernel on the
    bf16 inputs the path sends to ``"sm90"`` (it takes every supported
    input), but never ``"sm90"`` for inputs it does not take.  With
    ``return_lse`` returns (O, lse)."""
    global LAUNCHES
    _check(q, k, v)
    B, H, tq, D = q.shape
    routed = _variant(q.dtype, D)
    if variant not in (routed, "f32"):
        raise MXNetError(f"flash_attention_fwd: the {variant} kernel does "
                         f"not take {q.dtype} with head dim {D}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    _ENTRIES[variant](q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lse is None else lse.data_ptr(),
                      B * H, tq, k.shape[2], D, float(scale),
                      int(bool(causal)), _DTYPE_CODE[q.dtype])
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] += 1
    return (out, lse) if return_lse else out


def flash_attention_fwd(q, k, v, scale, causal, return_lse=False):
    """O (B, H, Tq, D) from q (B, H, Tq, D), k and v (B, H, Tk, D).

    With ``return_lse`` returns (O, lse): each row's log-sum-exp of the
    scaled, masked scores (float32 (B, H, Tq), natural log), which both
    kernels (and the plain version on the CPU) write for the backward.

    Meta tensors (shape inference) give an empty output of O's shape and
    dtype on the meta device: no numbers are computed, so nothing runs."""
    devices = {q.device.type, k.device.type, v.device.type}
    if _introspect.COUNTING:
        B, H, tq, D = q.shape
        _introspect.note_kernel(
            "flash_attention_fwd", 4.0 * B * H * tq * k.shape[2] * D,
            _nbytes(q, k, v, q) + (4 * B * H * tq if return_lse else 0),
            q.dtype)
        if devices == {"cpu"}:
            with _introspect.uncounted():
                return dense_reference(q, k, v, scale, causal, return_lse)
    if devices == {"cpu"}:
        return dense_reference(q, k, v, scale, causal, return_lse)
    if devices == {"meta"}:
        out = torch.empty_like(q)
        return (out, torch.empty(q.shape[:3], dtype=torch.float32,
                                 device="meta")) if return_lse else out
    return _launch(_variant(q.dtype, q.shape[3]), q, k, v, scale, causal,
                   return_lse)


def _bwd_launch(variant, q, k, v, o, do, scale, causal, lse=None):
    """Check the CUDA inputs, launch backward kernel ``variant`` and count
    it.  As in ``_launch``, a measurement may name ``"f32"`` for bf16 inputs
    routed to ``"sm90"``.  Both kernels need the forward's ``lse``."""
    global LAUNCHES, BWD_LAUNCHES
    _check(q, k, v, "flash_attention_bwd", o=o, do=do)
    B, H, tq, D = q.shape
    routed = _bwd_variant(q.dtype, D)
    if variant not in (routed, "f32"):
        raise MXNetError(f"flash_attention_bwd: the {variant} kernel does "
                         f"not take {q.dtype} with head dim {D}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if lse is None or lse.shape != (B, H, tq) or \
            lse.dtype != torch.float32 or lse.device != q.device or \
            not lse.is_contiguous():
        raise MXNetError(
            f"flash_attention_bwd: the {variant} kernel needs the forward's "
            f"row log-sum-exp, a contiguous float32 {(B, H, tq)} tensor "
            f"on {q.device} (flash_attention_fwd(..., return_lse=True))")
    planes = torch.empty(2 * B * H * (-(-tq // 64) * 64),
                         dtype=torch.float32, device=q.device)
    _BWD_ENTRIES[variant](q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                          planes.data_ptr(), B * H, tq, k.shape[2], D,
                          float(scale), int(bool(causal)),
                          _DTYPE_CODE[q.dtype])
    LAUNCHES += 1
    BWD_LAUNCHES += 1
    BWD_VARIANT_LAUNCHES[variant] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, scale, causal, lse=None):
    """dq, dk, dv of ``flash_attention_fwd`` at (q, k, v) whose output is o,
    for the output gradient dO (shaped like q; made contiguous here, since
    it arrives as a permuted view from the attention ops).  ``lse`` is the
    forward's row log-sum-exp (``flash_attention_fwd(..., return_lse=True)``),
    which both kernels read; the plain version on the CPU takes P from it
    where given, else from the softmax.

    Meta tensors give empty outputs shaped like q, k and v."""
    devices = {t.device.type for t in (q, k, v, o, do)}
    if _introspect.COUNTING:
        B, H, tq, D = q.shape
        _introspect.note_kernel(
            "flash_attention_bwd", 8.0 * B * H * tq * k.shape[2] * D,
            2 * _nbytes(q, k, v) + _nbytes(o, do)
            + (4 * B * H * tq if lse is not None else 0), q.dtype)
        if devices == {"cpu"}:
            with _introspect.uncounted():
                return bwd_reference(q, k, v, o, do, scale, causal, lse)
    if devices == {"cpu"}:
        return bwd_reference(q, k, v, o, do, scale, causal, lse)
    if devices == {"meta"}:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return _bwd_launch(_bwd_variant(q.dtype, q.shape[3]), q, k, v, o,
                       do.contiguous(), scale, causal, lse)
