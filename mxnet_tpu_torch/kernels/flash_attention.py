"""Flash-attention forward: the wrapper around ``csrc/flash_attention_fwd.cu``.

Replaces ``mxnet_tpu/ops/flash_attention.py:_flash_attention`` (the Pallas
kernel ``_fa_kernel``): O = softmax(scale * Q K^T [causal mask -1e30]) V with
an online softmax kept in float32.

Bound on an H100 SXM at the serving shape (B*H = 64, T = 1024, D = 64,
bf16, causal): 8.6 GFLOP is about 9 us at 989 TFLOP/s and the 33.6 MB of
q, k, v and o about 10 us at 3.35 TB/s, so the bytes bound it.  The kernel
does float32 FMAs on the CUDA cores; see the source for its design.

A CPU tensor takes ``dense_reference``, the plain version.  A CUDA tensor
launches the kernel or raises: nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

NEG_INF = -1e30
SUPPORTED_D = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by flash_attention_fwd in this process
LAUNCHES = 0


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


def _lib():
    lib = _build.load("flash_attention_fwd")
    lib.mxt_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.mxt_flash_attention_fwd.restype = ctypes.c_int
    return lib


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
    if D not in SUPPORTED_D:
        raise MXNetError(f"flash_attention_fwd: head dim {D} not in "
                         f"{SUPPORTED_D}")
    if min(q.shape[2], k.shape[2], B * H) < 1:
        raise MXNetError("flash_attention_fwd: empty input")


def flash_attention_fwd(q, k, v, scale, causal):
    """O (B, H, Tq, D) from q (B, H, Tq, D), k and v (B, H, Tk, D)."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return dense_reference(q, k, v, scale, causal)
    _check(q, k, v)
    global LAUNCHES
    lib = _lib()
    B, H, tq, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mxt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, tq, k.shape[2], D, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    LAUNCHES += 1
    return out
