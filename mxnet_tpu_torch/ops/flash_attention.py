"""Attention operators: flash attention, fused multi-head attention, the
one-token decode step over a KV cache, arange_like.

The counterpart of ``mxnet_tpu/ops/flash_attention.py``.  The flash path runs
the hand-written CUDA kernels (``kernels/flash_attention.py``) on a CUDA
tensor and their plain versions on a CPU tensor: the forward K1, and under
``autograd.record()`` the backward K1b, tied together by
``FlashAttentionFn`` as the JAX package ties ``_fa_bwd`` to its Pallas
forward with ``jax.custom_vjp``.  When the sequence length is not
divisible by the op's block size the op computes dense attention, which
torch's autograd differentiates: that is the op's definition (the JAX
package does the same), not a fallback.
The decode step is plain torch: the JAX package computes it in ``jnp`` too,
outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from ..base import Arg
from ..kernels.flash_attention import (NEG_INF, dense_reference,
                                       flash_attention_bwd,
                                       flash_attention_fwd)
from .registry import register

_dense_reference = dense_reference


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward, K1b backward.  The residuals are q, k, v and o, as in the
    JAX package's ``_fa_fwd``, and the forward's row log-sum-exp, which
    every kernel (and the plain version on the CPU) writes when asked: the
    backward reads it instead of recomputing it, 4 bytes per query row.
    The gradient is the same function."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_attention_fwd(q, k, v, scale, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, ctx.scale,
                                         ctx.causal, lse)
        return dq, dk, dv, None, None


def _flash_attention(q, k, v, scale, causal, blk_q, blk_k):
    if q.shape[2] % blk_q or k.shape[2] % blk_k:
        return _dense_reference(q, k, v, scale, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, scale, causal)
    return flash_attention_fwd(q, k, v, scale, causal)


@register("_contrib_flash_attention", input_names=("q", "k", "v"),
          aliases=("flash_attention",),
          args=[Arg("causal", bool, False), Arg("scale", float, -1.0),
                Arg("block_q", int, 128), Arg("block_k", int, 128)])
def _flash_attention_op(p, q, k, v):
    """Memory-efficient attention: q/k/v (B, H, T, D) → (B, H, T, D).
    Strided views (``MultiHeadAttention``'s slices of a transposed
    projection) are copied to contiguous memory first, as the kernels read
    it; a contiguous input is used as it is."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = p["scale"] if p["scale"] > 0 else q.shape[-1] ** -0.5
    blk_q = min(p["block_q"], q.shape[2])
    blk_k = min(p["block_k"], k.shape[2])
    return _flash_attention(q, k, v, float(scale), bool(p["causal"]),
                            int(blk_q), int(blk_k))


@register("_contrib_mha_decode_step",
          input_names=("qkv", "k_cache", "v_cache", "pos"),
          aliases=("mha_decode_step",), f32_inputs=(3,),
          args=[Arg("num_heads", int, required=True),
                Arg("scale", float, -1.0), Arg("impl", str, "dense")],
          num_outputs=3, differentiable=False)
def _mha_decode_step_op(p, qkv, kc, vc, pos):
    """One autoregressive attention step over a KV cache (inference).

    qkv: (B, 1, 3*D), the current token's fused projections; k_cache and
    v_cache: (B, H, Tmax, dh); pos: (1,) float, the current position t.
    Returns (out (B, 1, D), new_k_cache, new_v_cache): the caches with this
    token's K/V in column t, and attention over columns <= t.  Scores and
    softmax are float32; the output takes qkv's dtype, the caches keep
    theirs.

    The input caches are not written: each step returns new ones (JAX's
    ``dynamic_update_slice`` is functional too), which copies both caches.
    ``pos`` stays on the device: the column is an index tensor and the mask
    compares against it, so a step never waits for the card.  As with
    ``dynamic_update_slice``, a column past either end is clamped into the
    cache; the mask uses t itself.
    """
    B, _, D3 = qkv.shape
    H = p["num_heads"]
    D = D3 // 3
    dh = D // H
    if p["impl"] in ("ring", "ulysses"):
        raise NotImplementedError(
            f"mha_decode_step impl={p['impl']!r}: decoding over sharded "
            "caches is not ported yet (ROADMAP.md, queue item 6: scale-out)")
    if p["impl"] != "dense":
        raise ValueError(f"mha_decode_step impl={p['impl']!r}: choose "
                         "'dense'")
    x = qkv.reshape(B, 3, H, dh)                    # T=1 folded away
    q, k, v = x[:, 0], x[:, 1], x[:, 2]             # (B, H, dh)
    tmax = kc.shape[2]
    t = pos.reshape(()).to(torch.int64)
    col = torch.clamp(t, 0, tmax - 1).reshape(1)
    kc = kc.index_copy(2, col, k[:, :, None, :].to(kc.dtype))
    vc = vc.index_copy(2, col, v[:, :, None, :].to(vc.dtype))
    scale = p["scale"] if p["scale"] > 0 else dh ** -0.5
    s = torch.einsum("bhd,bhtd->bht", q.float() * scale, kc.float())
    s = s.masked_fill(torch.arange(tmax, device=kc.device) > t, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bht,bhtd->bhd", w, vc.float())
    return out.reshape(B, 1, D).to(qkv.dtype), kc, vc


@register("_contrib_multihead_attention", input_names=("qkv",),
          aliases=("multihead_attention",),
          args=[Arg("num_heads", int, required=True),
                Arg("causal", bool, True), Arg("impl", str, "dense"),
                Arg("scale", float, -1.0)])
def _multihead_attention_op(p, qkv):
    """Fused multi-head self-attention over packed projections.

    qkv: (B, T, 3*D), the output of one Dense QKV projection, split as
    (B, T, 3, H, dh); returns (B, T, D).  impl='flash' runs the CUDA
    kernels (K1, and K1b for the gradient), 'dense' materializes the
    scores.
    """
    B, T, D3 = qkv.shape
    H = p["num_heads"]
    D = D3 // 3
    dh = D // H
    if p["impl"] not in ("dense", "flash"):
        raise NotImplementedError(
            f"multihead_attention impl={p['impl']!r}: sequence-parallel "
            "attention ('ring', 'ulysses') is not ported yet (ROADMAP.md, "
            "queue item 6: scale-out)")
    # one copy into (3, B, H, T, dh): q, k and v are then contiguous views
    x = qkv.reshape(B, T, 3, H, dh).permute(2, 0, 3, 1, 4).contiguous()
    q, k, v = x[0], x[1], x[2]
    scale = p["scale"] if p["scale"] > 0 else dh ** -0.5
    if p["impl"] == "flash":
        out = _flash_attention(q, k, v, float(scale), bool(p["causal"]),
                               min(128, T), min(128, T))
    else:
        out = _dense_reference(q, k, v, float(scale), bool(p["causal"]))
    return out.permute(0, 2, 1, 3).reshape(B, T, D)


@register("_contrib_arange_like", input_names=("data",),
          aliases=("arange_like",), differentiable=False,
          args=[Arg("axis", int, None), Arg("start", float, 0.0),
                Arg("step", float, 1.0)])
def _arange_like(p, x):
    """A [start, start+step, ...] ramp shaped like `data` along `axis`
    (float32), or flat over all elements (float64, as the JAX package's
    x64 promotion of ``start + step * arange(n)`` gives)."""
    if p["axis"] is None:
        n = x.numel()
        ramp = torch.arange(n, dtype=torch.float64, device=x.device)
        return (p["start"] + p["step"] * ramp).reshape(x.shape)
    n = x.shape[p["axis"]]
    return p["start"] + p["step"] * torch.arange(n, dtype=torch.float32,
                                                 device=x.device)

