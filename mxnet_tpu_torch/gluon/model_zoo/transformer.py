"""Transformer language-model family (gluon), the port's serving slice.

The counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py``, ported
nearly line for line: a pre-LN GPT-style decoder, x + MHSA(LN(x));
x + FFN(LN(x)).  Attention runs as ``dense`` (materialized scores) or
``flash`` (the hand-written CUDA flash-attention kernel on the card).

Decoding here is the static-shape path: tokens live in a fixed
(B, max_len) buffer and every step is one full forward over it, greedy on
the device or sampled on the host.  The KV-cache decode, beam search, the
decode-step export and the sequence-parallel attention types are not ported
yet (ROADMAP.md, queue items 1 and 6); they
raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from .. import nn
from ..block import HybridBlock

_KV_ITEM = ("the KV-cache decode path is not ported yet (ROADMAP.md, "
            "queue item 1: KV-cache decode with mha_decode_step)")


def _write_frontier(F, tokens, pos, nxt, depth):
    """Scatter nxt (N, 1) into tokens (N, Tmax) at column pos+1."""
    oh = F.one_hot(pos + 1.0, depth=depth)
    return tokens * (1.0 - oh) + nxt * oh


class MultiHeadSelfAttention(HybridBlock):
    """Causal multi-head self-attention over (B, T, D) activations.

    attn_type: 'dense' | 'flash' (the CUDA flash-attention kernel)."""

    def __init__(self, dim, num_heads, attn_type="dense", dropout=0.0,
                 **kw):
        super().__init__(**kw)
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not divisible by num_heads "
                             f"{num_heads}")
        if attn_type in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_type {attn_type!r}: sequence-parallel attention is "
                "not ported yet (ROADMAP.md, queue item 6: scale-out)")
        if attn_type not in ("dense", "flash"):
            raise ValueError(f"unknown attn_type {attn_type!r}")
        self._h = num_heads
        self._dh = dim // num_heads
        self._type = attn_type
        with self.name_scope():
            self.qkv = nn.Dense(3 * dim, use_bias=True, flatten=False,
                                prefix="qkv_")
            self.proj = nn.Dense(dim, use_bias=True, flatten=False,
                                 prefix="proj_")
            self.drop = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        qkv = self.qkv(x)                                   # (B,T,3D)
        out = F.multihead_attention(qkv, num_heads=self._h, causal=True,
                                    impl=self._type)
        out = self.proj(out)
        return self.drop(out) if self.drop is not None else out


class TransformerBlock(HybridBlock):
    def __init__(self, dim, num_heads, ffn_dim, attn_type="dense",
                 dropout=0.0, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.ln1 = nn.LayerNorm(prefix="ln1_")
            self.attn = MultiHeadSelfAttention(dim, num_heads, attn_type,
                                               dropout, prefix="attn_")
            self.ln2 = nn.LayerNorm(prefix="ln2_")
            self.ffn1 = nn.Dense(ffn_dim, activation="relu", flatten=False,
                                 prefix="ffn1_")
            self.ffn2 = nn.Dense(dim, flatten=False, prefix="ffn2_")
            self.drop = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        h = self.ffn2(self.ffn1(self.ln2(x)))
        if self.drop is not None:
            h = self.drop(h)
        return x + h


class TransformerLM(HybridBlock):
    """GPT-style causal LM: token ids (B, T) → logits (B, T, vocab)."""

    def __init__(self, vocab, dim=128, num_layers=2, num_heads=4,
                 ffn_dim=None, max_len=512, attn_type="dense",
                 dropout=0.0, **kw):
        super().__init__(**kw)
        self._max_len = max_len
        with self.name_scope():
            self.tok = nn.Embedding(vocab, dim, prefix="tok_")
            self.pos = nn.Embedding(max_len, dim, prefix="pos_")
            self.blocks = nn.HybridSequential(prefix="blocks_")
            for i in range(num_layers):
                self.blocks.add(TransformerBlock(
                    dim, num_heads, ffn_dim or 4 * dim, attn_type,
                    dropout, prefix=f"l{i}_"))
            self.ln_f = nn.LayerNorm(prefix="lnf_")
            self.head = nn.Dense(vocab, flatten=False, prefix="head_")

    def hybrid_forward(self, F, tokens):
        if tokens.shape[1] > self._max_len:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds max_len "
                f"{self._max_len} — positions would silently clamp")
        pos_ids = F.broadcast_like(
            F.expand_dims(F.arange_like(tokens, axis=1), 0), tokens)
        x = self.tok(tokens) + self.pos(pos_ids)
        x = self.blocks(x)
        return self.head(self.ln_f(x))

    def generate(self, prompt, max_new, temperature=0.0, rng=None,
                 static_shapes=None, kv_cache=False, top_k=0,
                 top_p=0.0):
        """Autoregressive decoding from `prompt` (B, T0) float32 token ids.

        Greedy when temperature==0, else softmax sampling on the host.

        Static shapes: tokens live in a fixed (B, max_len) buffer and every
        decode step is one full forward over it; greedy stays on the device.
        Causality makes this exact: positions beyond the frontier hold
        zeros and cannot influence earlier logits.  The JAX package's
        debugging path (static_shapes=False) is not ported.
        """
        from ... import ndarray as F
        B, t0 = prompt.shape
        if t0 + max_new > self._max_len:
            raise ValueError(
                f"prompt length {t0} + max_new {max_new} "
                f"exceeds max_len {self._max_len}")
        if kv_cache:
            raise NotImplementedError(f"generate(kv_cache=True): {_KV_ITEM}")
        if static_shapes is False:
            raise NotImplementedError("generate(static_shapes=False) is not "
                                      "ported: the static-shape path is")
        steps = self._decode_steps()
        pad = self._max_len - t0
        buf = prompt if pad == 0 else F.concat(
            prompt, F.zeros((B, pad), ctx=prompt.device), dim=1)
        for t in range(t0, t0 + max_new):
            pos = F.array([t - 1.0], ctx=prompt.device)
            if temperature == 0:
                buf = steps["greedy"](buf, pos)      # fully on device
            else:
                last = steps["logits"](buf, pos)     # (B, V)
                nxt = self._sample(last, temperature, rng, top_k, top_p)
                buf = steps["write"](buf, pos,
                                     F.array(nxt, ctx=prompt.device))
        return F.slice_axis(buf, axis=1, begin=0, end=t0 + max_new)

    def beam_search(self, prompt, max_new, beam=4):
        raise NotImplementedError(f"beam_search: {_KV_ITEM}")

    def export_decode_step(self, prefix, batch_size=1):
        raise NotImplementedError(f"export_decode_step: {_KV_ITEM}")

    @staticmethod
    def _sample(last, temperature, rng, top_k=0, top_p=0.0):
        """Host-side next-token choice from (B, V) logits -> (B, 1).

        top_k > 0 keeps only the k most likely tokens; 0 < top_p <= 1
        keeps the smallest set whose cumulative probability reaches
        top_p (nucleus sampling, always at least the argmax); both
        filters compose (top-k first, then top-p)."""
        from ...ndarray import asnumpy
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if temperature <= 0:
            return asnumpy(last).argmax(-1).astype(np.float32)[:, None]
        logits = asnumpy(last).astype(np.float64) / temperature
        out = np.empty((logits.shape[0], 1), np.float32)
        r = rng or np.random
        for b, row in enumerate(logits):
            if top_k and top_k < row.size:
                # exactly k survivors even under ties, chosen in
                # stable (first-occurrence) order so top_k=1 keeps
                # precisely the greedy argmax token
                keep = np.argsort(-row, kind="stable")[:top_k]
                masked = np.full_like(row, -np.inf)
                masked[keep] = row[keep]
                row = masked
            p = np.exp(row - row.max())
            p /= p.sum()
            if 0.0 < top_p < 1.0:
                order = np.argsort(-p)
                cum = np.cumsum(p[order])
                # keep the minimal prefix reaching top_p (>= 1 token)
                cut = int(np.searchsorted(cum, top_p)) + 1
                mask = np.zeros_like(p, bool)
                mask[order[:cut]] = True
                p = np.where(mask, p, 0.0)
                p /= p.sum()
            out[b, 0] = r.choice(p.size, p=p)
        return out

    def _decode_steps(self):
        """Build (once) the three decode-step blocks.

        Stored in __dict__ via a plain dict so the model does not register
        them as children (each wrapper holds the model as its child)."""
        cached = self.__dict__.get("_decode_step_cache")
        if cached is not None:
            return cached
        outer = self

        def _write_at(F, tokens, pos, nxt):
            return _write_frontier(F, tokens, pos, nxt, outer._max_len)

        class _LogitsStep(HybridBlock):
            """(tokens (B,Tmax), pos (1,)) -> logits at pos, (B, V)."""

            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.net = outer

            def hybrid_forward(self, F, tokens, pos):
                logits = self.net(tokens)            # (B, Tmax, V)
                last = F.take(logits, pos, axis=1)   # (B, 1, V)
                return F.reshape(last, (0, -1))

        class _GreedyStep(_LogitsStep):
            """One whole greedy step on device: read logits at pos,
            argmax, write the winner at pos+1; returns the updated
            (B, Tmax) buffer."""

            def hybrid_forward(self, F, tokens, pos):
                last = super().hybrid_forward(F, tokens, pos)
                nxt = F.argmax(last, axis=-1, keepdims=True)  # (B, 1)
                return _write_at(F, tokens, pos, nxt)

        class _WriteStep(HybridBlock):
            """(tokens, pos, nxt (B,1)) -> tokens with nxt at pos+1."""

            def hybrid_forward(self, F, tokens, pos, nxt):
                return _write_at(F, tokens, pos, nxt)

        steps = {"logits": _LogitsStep(), "greedy": _GreedyStep(),
                 "write": _WriteStep()}
        for blk in steps.values():
            blk._active = True                 # this wrapper only
        self.__dict__["_decode_step_cache"] = steps
        return steps


def transformer_lm(vocab, **kwargs):
    return TransformerLM(vocab, **kwargs)
