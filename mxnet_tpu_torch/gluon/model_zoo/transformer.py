"""Transformer language-model family (gluon), the port's serving slice.

The counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py``, ported
nearly line for line: a pre-LN GPT-style decoder, x + MHSA(LN(x));
x + FFN(LN(x)).  Attention runs as ``dense`` (materialized scores) or
``flash`` (the hand-written CUDA flash-attention kernel on the card).

Decoding:

* static shapes (the default): tokens live in a fixed (B, max_len) buffer
  and every step is one full forward over it, greedy on the device or
  sampled on the host; ``static_shapes=False`` re-runs the forward on the
  growing prefix (the eager reference);
* ``kv_cache=True``: per-layer K/V caches and one token per step through
  ``mha_decode_step``; the prompt is fed one token at a time through the
  same cell (prefill fills the caches);
* ``beam_search``: the KV cell with beams as batch rows.

The KV cell and the beam step re-compose the same sub-blocks and
parameters as the forward.  The decode-step wrappers are active blocks:
each traces itself into a Symbol graph once and runs it through its
``CachedOp``.  The decode-step export needs ``model.save_checkpoint``
(ROADMAP.md, queue item 3), and the sequence-parallel attention types need
scale-out (queue item 6); both raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from .. import nn
from ..block import HybridBlock
from ...symbol import Symbol


def _write_frontier(F, tokens, pos, nxt, depth):
    """Scatter nxt (N, 1) into tokens (N, Tmax) at column pos+1 (static
    greedy/sampled decode and the beam step share it)."""
    oh = F.one_hot(pos + 1.0, depth=depth)
    return tokens * (1.0 - oh) + nxt * oh


def _kv_forward(F, net, tok, pos, caches):
    """The one-token decode stack walk shared by the KV and beam cells:
    (tok (N,1) ids, pos (1,), 2L caches (N,H,Tmax,dh)) -> (logits
    (N, V), updated caches)."""
    x = net.tok(tok) + F.expand_dims(net.pos(pos), axis=0)
    new_caches = []
    for i, blk in enumerate(net.blocks._children):
        h = blk.ln1(x)
        qkv = blk.attn.qkv(h)                       # (N, 1, 3D)
        att, kc, vc = F.mha_decode_step(
            qkv, caches[2 * i], caches[2 * i + 1], pos,
            num_heads=blk.attn._h, impl="dense")
        new_caches += [kc, vc]
        x = x + blk.attn.proj(att)
        x = x + blk.ffn2(blk.ffn1(blk.ln2(x)))
    logits = net.head(net.ln_f(x))                  # (N, 1, V)
    return F.reshape(logits, (0, -1)), new_caches


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

    def forward(self, tokens, *args):
        # checked here, not in hybrid_forward: a hybridized net traces a
        # Symbol, which has no shape, and then runs the graph on tensors
        if not isinstance(tokens, Symbol) and \
                tokens.shape[1] > self._max_len:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds max_len "
                f"{self._max_len} — positions would silently clamp")
        return super().forward(tokens, *args)

    def hybrid_forward(self, F, tokens):
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

        static_shapes=True (default): tokens live in a fixed (B, max_len)
        buffer and every decode step is one full forward over it; greedy
        stays on the device.  Causality makes this exact: positions beyond
        the frontier hold zeros and cannot influence earlier logits.

        static_shapes=False re-runs the forward on the growing prefix (the
        eager reference).

        kv_cache=True decodes through per-layer K/V caches
        (``mha_decode_step``): O(Tmax*D) work per token instead of the full
        re-forward's O(Tmax^2*D).
        """
        from ... import ndarray as F
        B, t0 = prompt.shape
        if t0 + max_new > self._max_len:
            raise ValueError(
                f"prompt length {t0} + max_new {max_new} "
                f"exceeds max_len {self._max_len}")
        if kv_cache:
            if static_shapes is not None:
                raise ValueError(
                    "kv_cache=True selects its own decode strategy; "
                    "combining it with an explicit static_shapes "
                    "would be silently ignored — pass one or the other")
            self._check_kv_supported()
            return self._generate_kv(prompt, max_new, temperature, rng,
                                     top_k, top_p)
        if static_shapes is not None and not static_shapes:
            toks = prompt
            for _ in range(max_new):
                logits = self(toks)                  # (B, T, V)
                last = logits[:, -1, :]
                nxt = self._sample(last, temperature, rng, top_k, top_p)
                toks = F.concat(toks, F.array(nxt, ctx=toks.device), dim=1)
            return toks
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

    def _init_caches(self, batch, ctx=None, dtype=None, sharded=None):
        """Zero per-layer K/V caches, (batch, H, max_len, dh) x 2L (KV
        decode and beam search share them).  Caches sharded over a mesh
        (``sharded=``) come with scale-out."""
        from ... import ndarray as F
        if sharded is not None:
            raise NotImplementedError(
                "sharded KV caches are not ported yet (ROADMAP.md, queue "
                "item 6: scale-out)")
        blocks = self.blocks._children
        h, dh = blocks[0].attn._h, blocks[0].attn._dh
        shape = (batch, h, self._max_len, dh)
        return [F.zeros(shape, ctx=ctx, dtype=dtype)
                for _ in range(2 * len(blocks))]

    def _check_kv_supported(self):
        """The KV cell decodes over dense caches: every block's attention
        must be 'dense' or 'flash' (the sequence-parallel types decode over
        sharded caches, which come with scale-out)."""
        for blk in self.blocks._children:
            if blk.attn._type not in ("dense", "flash"):
                raise NotImplementedError(
                    f"attn_type {blk.attn._type!r} cannot decode with a KV "
                    "cache yet (ROADMAP.md, queue item 6: scale-out)")

    def beam_search(self, prompt, max_new, beam=4):
        """Beam-search decoding over the KV-cache cell.

        Returns (sequences (B, T0+max_new), log_probs (B,)): the
        highest-scoring beam per example and its total log-probability over
        the generated positions (float64, as the JAX package's).  Beams ride
        as batch rows (B*beam); the top-k over combined scores, the
        beam/cache reindex and the frontier write stay on the device, and
        the host fetches once at the end.  No EOS handling: every beam runs
        the full max_new.
        """
        from ... import ndarray as F
        from ...ndarray import asnumpy
        if beam < 1:
            raise ValueError("beam must be >= 1")
        B, t0 = prompt.shape
        if t0 + max_new > self._max_len:
            raise ValueError(
                f"prompt length {t0} + max_new {max_new} "
                f"exceeds max_len {self._max_len}")
        self._check_kv_supported()
        W = beam
        ctx = prompt.device
        prefill = self._kv_step()["sample"]
        step = self._beam_step(W)
        positions = self._positions(t0 + max_new - 1, ctx)
        # prefill at B rows (beams are identical over the prompt), then
        # repeat the caches to B*W: the prompt does not pay the beam width
        caches = self._init_caches(B, ctx=ctx, dtype=self.head.weight.dtype)
        for t in range(t0 - 1):
            outs = prefill(prompt[:, t:t + 1], positions[t:t + 1], *caches)
            caches = outs[1:]
        caches = [F.repeat(c, repeats=W, axis=0) for c in caches]
        toks_np = np.repeat(asnumpy(prompt), W, axis=0)        # (BW, t0)
        pad = self._max_len - t0
        buf = F.array(np.concatenate(
            [toks_np, np.zeros((B * W, pad), "f")], axis=1)
            if pad else toks_np, ctx=ctx)
        # only beam 0 contributes until beams diverge
        cum = F.array(np.tile([0.0] + [-1e30] * (W - 1), (B, 1)), ctx=ctx)
        offsets = F.array(np.arange(B)[:, None] * W *
                          np.ones((1, W), "f"), ctx=ctx)
        cur = F.array(toks_np[:, t0 - 1:t0], ctx=ctx)
        for t in range(t0 - 1, t0 + max_new - 1):
            outs = step(cur, positions[t:t + 1], cum, buf, offsets, *caches)
            cur, cum, buf, caches = outs[0], outs[1], outs[2], outs[3:]
        buf_np = asnumpy(buf)[:, :t0 + max_new].reshape(B, W, -1)
        cum_np = asnumpy(cum)                    # (B, W), sorted desc
        return (F.array(buf_np[:, 0, :], ctx=ctx),
                F.array(cum_np[:, 0], ctx=ctx))

    def export_decode_step(self, prefix, batch_size=1):
        raise NotImplementedError(
            "export_decode_step writes the KV cell's graph with "
            "model.save_checkpoint, which is not ported yet (ROADMAP.md, "
            "queue item 3: the executor and model checkpoints)")

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

    def _kv_step(self):
        """Build (once) the KV-cache decode cell: (token_t, pos, *caches)
        -> [head, *updated caches].  Same child-registration rule as
        _decode_steps."""
        cached = self.__dict__.get("_kv_step_cache")
        if cached is not None:
            return cached
        outer = self

        class _KVStep(HybridBlock):
            """(token_t (B,1), pos (1,), *caches) -> [head, *caches].
            greedy=True emits the argmax next token as the head output (it
            stays on the device and feeds the next step); greedy=False
            emits the (B, V) logits for host-side sampling."""

            def __init__(self, greedy, **kw):
                super().__init__(**kw)
                self._greedy = greedy
                with self.name_scope():
                    self.net = outer

            def hybrid_forward(self, F, tok, pos, *caches):
                logits, new_caches = _kv_forward(F, self.net, tok, pos,
                                                 caches)
                head = (F.argmax(logits, axis=-1, keepdims=True)
                        if self._greedy else logits)
                return [head] + new_caches

        steps = {"sample": _KVStep(False), "greedy": _KVStep(True)}
        for blk in steps.values():
            blk._active = True                  # this wrapper only
        self.__dict__["_kv_step_cache"] = steps
        return steps

    @staticmethod
    def _positions(n, ctx):
        """Positions 0..n-1 as one float32 tensor on ``ctx``: a step takes
        its (1,) slice, so no step uploads from the host."""
        from ... import ndarray as F
        return F.array(np.arange(n, dtype=np.float32), ctx=ctx)

    def _generate_kv(self, prompt, max_new, temperature, rng,
                     top_k=0, top_p=0.0):
        """KV-cache decode loop: prefill feeds the prompt's tokens through
        the same one-token cell that generates (the caches fill as a side
        effect).  Greedy keeps the whole loop on the device: each chosen
        token is a (B, 1) tensor that feeds the next step, and the host
        fetches the tokens once, at the end."""
        from ... import ndarray as F
        B, t0 = prompt.shape
        ctx = prompt.device
        greedy = temperature == 0
        cell = self._kv_step()["greedy" if greedy else "sample"]
        caches = self._init_caches(B, ctx=ctx, dtype=self.head.weight.dtype)
        positions = self._positions(t0 + max_new - 1, ctx)
        pieces = [prompt]                  # (B, k) device-side chunks
        cur = prompt[:, 0:1]
        for t in range(t0 + max_new - 1):
            outs = cell(cur, positions[t:t + 1], *caches)
            head, caches = outs[0], outs[1:]
            if t + 1 < t0:                 # prefill: next prompt column
                cur = prompt[:, t + 1:t + 2]
            elif greedy:
                cur = head                 # stays on device
                pieces.append(cur)
            else:
                nxt = self._sample(head, temperature, rng, top_k, top_p)
                cur = F.array(nxt, ctx=ctx)
                pieces.append(cur)
        return F.concat(*pieces, dim=1)

    def _beam_step(self, width):
        """Build (once per width) the beam-search step cell: it advances
        every beam one token (decode-stack logits, log-softmax, combined
        scores, top-k over width*vocab, beam/cache reindex by ``take``,
        frontier write).  Inputs: (cur (B*W,1), pos (1,), cum (B,W), buf
        (B*W,Tmax), offsets (B,W) = arange(B)*W, *caches); outputs: [cur',
        cum', buf', *caches']."""
        cache = self.__dict__.setdefault("_beam_step_cache", {})
        if width in cache:
            return cache[width]
        outer = self
        vocab = self.head._units

        class _BeamStep(HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.net = outer

            def hybrid_forward(self, F, cur, pos, cum, buf, offsets,
                               *caches):
                W, V = width, vocab
                logits, new_caches = _kv_forward(F, self.net, cur, pos,
                                                 caches)        # (BW, V)
                logp = F.log_softmax(logits, axis=-1)
                scores = F.reshape(cum, (-1, 1)) + logp         # (BW, V)
                scores = F.reshape(scores, (-1, W * V))         # (B, W*V)
                idx = F.topk(scores, k=W, ret_typ="indices", axis=-1,
                             is_ascend=False)                   # (B, W)
                new_cum = F.topk(scores, k=W, ret_typ="value", axis=-1,
                                 is_ascend=False)               # (B, W)
                beam_src = F.floor(idx / V)                     # (B, W)
                tok = idx - beam_src * V                        # (B, W)
                flat_src = F.reshape(beam_src + offsets, (-1,))  # (BW,)
                buf = F.take(buf, flat_src, axis=0)
                new_caches = [F.take(c, flat_src, axis=0)
                              for c in new_caches]
                tokcol = F.reshape(tok, (-1, 1))                # (BW, 1)
                buf = _write_frontier(F, buf, pos, tokcol, outer._max_len)
                return [tokcol, new_cum, buf] + new_caches

        step = _BeamStep()
        step._active = True                     # this wrapper only
        cache[width] = step
        return step


def transformer_lm(vocab, **kwargs):
    return TransformerLM(vocab, **kwargs)
