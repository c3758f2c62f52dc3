"""Flash-attention forward: the wrapper around its two CUDA kernels.

Replaces ``mxnet_tpu/ops/flash_attention.py:_flash_attention`` (the Pallas
kernel ``_fa_kernel``): O = softmax(scale * Q K^T [causal mask -1e30]) V with
an online softmax kept in float32.  Two kernels compute it, and
``_variant(dtype, head_dim)`` picks one from the input alone:

* ``"sm90"`` (``csrc/flash_attention_fwd_sm90.cu``): bfloat16 with head dim
  64 or 128, on the tensor cores (wgmma, TMA, a pipelined K/V ring).
* ``"f32"`` (``csrc/flash_attention_fwd.cu``): float32 at every head dim,
  and bfloat16 at 16 or 32, with float32 FMAs on the CUDA cores (the f32
  pin of 1e-4 needs IEEE float32 products).

Bound on an H100 SXM at the serving shape (B*H = 64, T = 1024, D = 64,
bf16, causal): 8.6 GFLOP is about 9 us at 989 TFLOP/s and the 33.6 MB of
q, k, v and o about 10 us at 3.35 TB/s, so the bytes bound it.

A CPU tensor takes ``dense_reference``, the plain version.  A CUDA tensor
launches the kernel it routes to or raises: nothing falls back.  A meta
tensor (shape inference) gets an empty output of the right shape.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

NEG_INF = -1e30
SUPPORTED_D = (16, 32, 64, 128)
SM90_D = (64, 128)
SM90_BLOCK_N = 128  # keys per k-tile of the sm90 kernel (BN in its source)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, o, bh, tq, tk, d, scale, causal, dtype (then the stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
_ENTRIES = {
    "sm90": _build.Entry("flash_attention_fwd_sm90",
                         "mxt_flash_attention_fwd_sm90", _ARGTYPES),
    "f32": _build.Entry("flash_attention_fwd", "mxt_flash_attention_fwd",
                        _ARGTYPES),
}

# kernel launches made in this process: all of them, and by variant
LAUNCHES = 0
VARIANT_LAUNCHES = dict.fromkeys(_ENTRIES, 0)


def dense_reference(q, k, v, scale, causal):
    """Plain version: float32 scores and softmax, cast back to q's dtype.
    q (B, H, Tq, D), k and v (B, H, Tk, D)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _variant(dtype, d):
    """The kernel for inputs of ``dtype`` and head dim ``d``: ``"sm90"`` for
    bfloat16 at D 64 or 128, ``"f32"`` for every other supported case."""
    if dtype not in _DTYPE_CODE or d not in SUPPORTED_D:
        raise MXNetError(f"flash_attention_fwd: {dtype} with head dim {d} "
                         f"is not supported (float32 or bfloat16, D in "
                         f"{SUPPORTED_D})")
    return "sm90" if dtype == torch.bfloat16 and d in SM90_D else "f32"


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise MXNetError(f"flash_attention_fwd: {name} is on {t.device}, "
                             f"q on {q.device}; all must be on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise MXNetError(f"flash_attention_fwd: {name} is {t.dtype}; "
                             "q, k and v must all be float32 or bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise MXNetError(f"flash_attention_fwd: {name} must be a "
                             f"contiguous (B, H, T, D) tensor, got "
                             f"{tuple(t.shape)} with strides {t.stride()}")
        if t.data_ptr() % 16:
            raise MXNetError(f"flash_attention_fwd: {name} is not 16-byte "
                             "aligned")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or v.shape != k.shape or k.shape[3] != D:
        raise MXNetError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if min(q.shape[2], k.shape[2], B * H) < 1:
        raise MXNetError("flash_attention_fwd: empty input")


def _launch(variant, q, k, v, scale, causal):
    """Check the CUDA inputs, launch kernel ``variant`` and count it.  The
    path comes here through ``flash_attention_fwd``, with the routed
    variant; a measurement may name ``"f32"`` to time that kernel on the
    bf16 inputs the path sends to ``"sm90"`` (it takes every supported
    input), but never ``"sm90"`` for inputs it does not take."""
    global LAUNCHES
    _check(q, k, v)
    B, H, tq, D = q.shape
    routed = _variant(q.dtype, D)
    if variant not in (routed, "f32"):
        raise MXNetError(f"flash_attention_fwd: the {variant} kernel does "
                         f"not take {q.dtype} with head dim {D}")
    out = torch.empty_like(q)
    _ENTRIES[variant](q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B * H, tq, k.shape[2], D, float(scale),
                      int(bool(causal)), _DTYPE_CODE[q.dtype])
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] += 1
    return out


def flash_attention_fwd(q, k, v, scale, causal):
    """O (B, H, Tq, D) from q (B, H, Tq, D), k and v (B, H, Tk, D).

    Meta tensors (shape inference) give an empty output of O's shape and
    dtype on the meta device: no numbers are computed, so nothing runs."""
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return dense_reference(q, k, v, scale, causal)
    if devices == {"meta"}:
        return torch.empty_like(q)
    return _launch(_variant(q.dtype, q.shape[3]), q, k, v, scale, causal)
