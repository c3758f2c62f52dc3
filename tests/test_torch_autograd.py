"""The port's autograd against the JAX package's, on the CPU.

The same numpy inputs, from a seed, go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` (``ctx=cpu()``): the cases of ``tests/test_autograd.py``
that the port supports, the reductions and ``pick`` with their gradients,
and the flash-attention gradient, which on the CPU runs K1b's plain version
(``kernels.flash_attention.bwd_reference``) through ``FlashAttentionFn``,
against ``jax.grad`` through the JAX package's ``custom_vjp`` (``_fa_bwd``,
its Pallas forward in interpret mode).

Tolerances: 1e-5 for gradients of plain ops (float32 in both, summed in
another order); the flash gradient at the JAX package's own pin
(``tests/test_flash_attention.py:35-53``: rtol 1e-3, atol 1e-4), and 3e-2
in bfloat16 (its bf16 pin).  The port's documented differences from the
reference (ROADMAP.md §3) each have a test here that shows its behaviour.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops.flash_attention import _flash_attention as jax_flash
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
from mxnet_tpu_torch.kernels import flash_attention as kfa
from mxnet_tpu_torch.ops.flash_attention import FlashAttentionFn

CPU = mxt.cpu()


class _Jax:
    """The JAX package's spelling of the calls the cases make."""
    mx = mxj

    @staticmethod
    def array(a):
        return mxj.nd.array(a)

    @staticmethod
    def attach(x, req="write"):
        x.attach_grad(grad_req=req)
        return x

    @staticmethod
    def grad(x):
        return x.grad.asnumpy()

    @staticmethod
    def numpy(x):
        return x.asnumpy()


class _Port:
    mx = mxt

    @staticmethod
    def array(a):
        return mxt.nd.array(a, ctx=CPU)

    @staticmethod
    def attach(x, req="write"):
        return mxt.nd.attach_grad(x, req)

    @staticmethod
    def grad(x):
        return mxt.nd.asnumpy(mxt.nd.grad(x))

    @staticmethod
    def numpy(x):
        return mxt.nd.asnumpy(x)


def _basic(api, rs):
    x = api.attach(api.array(rs.randn(3, 4).astype("f")))
    with api.mx.autograd.record():
        y = (x * x + 2 * x).sum()
    y.backward()
    return [api.grad(x)]


def _chain_and_branches(api, rs):
    x = api.attach(api.array(rs.randn(3).astype("f")))
    with api.mx.autograd.record():
        a = x * 2
        b = a + x
        c = (b * b).sum()
    c.backward()
    return [api.grad(x)]


def _grad_req_add(api, rs):
    x = api.attach(api.array(rs.randn(2).astype("f")), "add")
    for _ in range(3):
        with api.mx.autograd.record():
            y = (x * x).sum()
        y.backward()
    return [api.grad(x)]


def _grad_req_write_overwrites(api, rs):
    x = api.attach(api.array(rs.randn(2).astype("f")))
    for k in (1.0, 5.0):
        with api.mx.autograd.record():
            y = (x * x * k).sum()
        y.backward()
    return [api.grad(x)]


def _head_grads(api, rs):
    x = api.attach(api.array(rs.randn(2).astype("f")))
    with api.mx.autograd.record():
        y = x * 3
    api.mx.autograd.backward([y], [api.array(rs.randn(2).astype("f"))])
    return [api.grad(x)]


def _detach(api, rs):
    x = api.attach(api.array(rs.randn(1).astype("f")))
    with api.mx.autograd.record():
        y = x * x
        z = y.detach() * x
    z.backward()
    return [api.grad(x)]


def _pause(api, rs):
    x = api.attach(api.array(rs.randn(3).astype("f")))
    with api.mx.autograd.record():
        a = x * x
        with api.mx.autograd.pause():
            b = x * 10          # not recorded: a constant to the graph
        y = (a + b).sum()
    y.backward()
    return [api.grad(x)]


def _retain_graph(api, rs):
    x = api.attach(api.array(rs.randn(1).astype("f")))
    with api.mx.autograd.record():
        y = x * x
    api.mx.autograd.backward([y], retain_graph=True)
    g1 = api.grad(x).copy()
    api.mx.autograd.backward([y])
    return [g1, api.grad(x)]


def _mark_variables(api, rs):
    x = api.array(rs.randn(2).astype("f"))
    g = api.mx.nd.zeros((2,), ctx=api.mx.cpu())
    api.mx.autograd.mark_variables([x], [g])
    with api.mx.autograd.record():
        y = (x ** 3).sum()
    y.backward()
    return [api.numpy(g)]


def _custom_function(api, rs):
    class Sigmoid(api.mx.autograd.Function):
        def forward(self, x):
            y = api.mx.nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = api.attach(api.array(rs.randn(5).astype("f")))
    with api.mx.autograd.record():
        y = Sigmoid()(x)
    api.mx.autograd.backward([y])
    return [api.grad(x)]


def _dropout_identity(api, rs):
    x = api.attach(api.array(rs.randn(10, 10).astype("f")))
    with api.mx.autograd.record(train_mode=False):
        y = api.mx.nd.Dropout(x, p=0.5)
    api.mx.autograd.backward([y])
    return [api.grad(x)]


def _recycling_stress(api, rs):
    x = api.attach(api.array(rs.randn(4, 4).astype("f")))
    with api.mx.autograd.record():
        acc = x * 1.0
        for i in range(8):
            tmp = acc * 2.0
            acc = tmp * 0.5 + x * 0.0
            del tmp
            if i % 7 == 0:
                gc.collect()
        loss = acc.sum()
    loss.backward()
    return [api.grad(x)]


def _views(api, rs):
    x = api.attach(api.array(rs.randn(3, 4).astype("f")))
    with api.mx.autograd.record():
        y = api.mx.nd.reshape(x, shape=(4, 3))
        loss = (y[0:2] * 2).sum() + x[1].sum() + x[:, 0:2].sum()
    loss.backward()
    return [api.grad(x)]


def _reductions(api, rs):
    x = api.attach(api.array(rs.randn(2, 3, 4).astype("f")))
    nd = api.mx.nd
    with api.mx.autograd.record():
        parts = [nd.sum(x, axis=1), nd.mean(x, axis=(0, 2), keepdims=True),
                 nd.prod(x, axis=2), nd.max(x, axis=0),
                 nd.min(x, axis=1, exclude=True), nd.nansum(x),
                 nd.nanprod(x, axis=-1)]
        w = [api.array(np.asarray(rs.randn(*api.numpy(p).shape), "f"))
             for p in parts]
        loss = sum((p * wi).sum() for p, wi in zip(parts, w))
    loss.backward()
    return [api.numpy(p) for p in parts] + [api.grad(x)]


def _pick(api, rs):
    x = api.attach(api.array(rs.randn(3, 5).astype("f")))
    idx = api.array(np.array([0, 4, 2], "f"))
    idx0 = api.array(np.array([1, 0, 7, -2, 3], "f"))   # clamped ids
    with api.mx.autograd.record():
        a = api.mx.nd.pick(x, idx, axis=-1)
        b = api.mx.nd.pick(x, idx0, axis=0, keepdims=True)
        loss = (a * 3).sum() + (b * b).sum()
    loss.backward()
    return [api.numpy(a), api.numpy(b), api.grad(x)]


_CASES = [_basic, _chain_and_branches, _grad_req_add,
          _grad_req_write_overwrites, _head_grads, _detach, _pause,
          _retain_graph, _mark_variables, _custom_function,
          _dropout_identity, _recycling_stress, _views, _reductions, _pick]


@pytest.mark.parametrize("case", _CASES, ids=[c.__name__[1:] for c in _CASES])
def test_gradients_match_jax(case):
    want = case(_Jax, np.random.RandomState(0))
    got = case(_Port, np.random.RandomState(0))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_recording_state_matches_jax():
    def states(ag):
        seen = [(ag.is_recording(), ag.is_training())]
        with ag.record():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                seen.append((ag.is_recording(), ag.is_training()))
            seen.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            seen.append((ag.is_recording(), ag.is_training()))
        with ag.train_mode():
            seen.append((ag.is_recording(), ag.is_training()))
        with ag.predict_mode():
            seen.append((ag.is_recording(), ag.is_training()))
        return seen

    assert states(mxt.autograd) == states(mxj.autograd)
    # recording is torch's grad mode, scoped
    assert torch.is_grad_enabled()
    with mxt.autograd.record():
        assert torch.is_grad_enabled()
        with mxt.autograd.pause():
            assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled()


def test_in_place_write_after_record_raises():
    """The reference differentiates the value a variable had when its ops
    were recorded (``tests/test_autograd.py::test_mutation_after_record``
    gives 4.0).  Torch refuses: an in-place write to a variable raises, and
    a write made under ``pause()`` makes the backward raise on the saved
    value's version (ROADMAP.md §3)."""
    x = mxt.nd.attach_grad(mxt.nd.array([2.0], ctx=CPU))
    with mxt.autograd.record():
        y = x * x
    with pytest.raises(RuntimeError, match="in-place"):
        x += 100
    with mxt.autograd.pause():
        x += 100
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.backward()


def test_grad_needs_variables_marked_before_recording():
    """``autograd.grad`` of a variable never marked works in the reference
    (its tape records every array); the port records through torch, so the
    variable must be marked first (ROADMAP.md §3)."""
    x = mxt.nd.array([1.0, 2.0], ctx=CPU)
    with mxt.autograd.record():
        y = (x * x).sum()
    with pytest.raises(MXNetError, match="attach_grad"):
        mxt.autograd.grad([y], [x])
    mxt.nd.attach_grad(x)
    with mxt.autograd.record():
        y = (x * x).sum()
    (g,) = mxt.autograd.grad([y], [x])
    xj = mxj.nd.array([1.0, 2.0])
    with mxj.autograd.record():
        yj = (xj * xj).sum()
    np.testing.assert_allclose(mxt.nd.asnumpy(g),
                               mxj.autograd.grad([yj], [xj])[0].asnumpy())


def test_no_graph_outside_record():
    """Scoring, generation and the hybridized graph outside ``record()``
    give tensors with no autograd history; the same net under ``record()``
    does build one."""
    net = TransformerLM(vocab=16, dim=16, num_layers=1, num_heads=2,
                        max_len=8, attn_type="flash")
    net.initialize(ctx=CPU)
    toks = mxt.nd.array(np.random.RandomState(0).randint(0, 16, (2, 6)),
                        ctx=CPU)
    outs = [net(toks), net.generate(toks[:, :3], 3),
            net.generate(toks[:, :3], 3, kv_cache=True)]
    net.hybridize()
    outs.append(net(toks))
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)
    with mxt.autograd.record():
        assert net(toks).grad_fn is not None


def _qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.normal(0, 1, shape).astype(np.float32) for _ in range(4)]


def _jax_flash_grads(arrays, scale, causal, blk, dtype):
    q, k, v, g = (jnp.asarray(a, dtype) for a in arrays)

    def loss(q, k, v):
        o = jax_flash(q, k, v, scale, causal, blk, blk)
        return jnp.sum(o.astype(jnp.float32) * g.astype(jnp.float32))
    return [np.asarray(t, np.float32)
            for t in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _port_flash_grads(arrays, scale, causal, blk, dtype):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    if blk == q.shape[2]:
        o = FlashAttentionFn.apply(q, k, v, scale, causal)
    else:                      # the op's dense path: the block does not divide
        o = mxt.nd.flash_attention(q, k, v, causal=causal, scale=scale,
                                   block_q=blk, block_k=blk)
    torch.autograd.backward([o], [g])
    return [t.grad.float().numpy() for t in (q, k, v)]


@pytest.mark.parametrize("shape,blk,dtype,causal", [
    ((1, 2, 64, 16), 64, "float32", False),   # the JAX package's own check
    ((1, 2, 64, 16), 64, "float32", True),
    ((1, 2, 100, 16), 64, "float32", True),   # 64 does not divide 100: dense
    ((1, 2, 64, 32), 64, "bfloat16", True)])
def test_flash_gradient_matches_jax(shape, blk, dtype, causal):
    arrays = _qkv(7, shape)
    scale = shape[-1] ** -0.5
    want = _jax_flash_grads(arrays, scale, causal, blk, jnp.dtype(dtype))
    got = _port_flash_grads(arrays, scale, causal, blk,
                            getattr(torch, dtype))
    tol = dict(rtol=1e-3, atol=1e-4) if dtype == "float32" \
        else dict(rtol=3e-2, atol=3e-2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


def test_flash_op_records_through_k1b(monkeypatch):
    """Under ``record()`` the multi-head attention op reaches K1b's wrapper
    once per call, with a contiguous dO (it arrives permuted) and the
    forward's row log-sum-exp; the plain backward runs because the tensors
    lie on the CPU."""
    calls = []
    real = kfa.flash_attention_bwd

    def spy(q, k, v, o, do, scale, causal, lse=None):
        assert lse is not None and lse.shape == q.shape[:3]
        calls.append(do.is_contiguous())
        return real(q, k, v, o, do, scale, causal, lse)

    monkeypatch.setattr("mxnet_tpu_torch.ops.flash_attention."
                        "flash_attention_bwd", spy)
    qkv = mxt.nd.attach_grad(mxt.nd.array(_qkv(3, (2, 64, 48))[0], ctx=CPU))
    with mxt.autograd.record():
        out = mxt.nd.multihead_attention(qkv, num_heads=2, impl="flash")
    mxt.autograd.backward([out])
    assert calls == [False]
    assert mxt.nd.grad(qkv).abs().sum() > 0


def test_bwd_wrapper_routes_by_device(monkeypatch):
    """CPU tensors take the plain backward, meta tensors get empty
    outputs, anything else launches or raises; nothing launches here."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(5, (1, 2, 64, 16)))
    o = kfa.dense_reference(q, k, v, 0.25, True)
    before = (kfa.LAUNCHES, kfa.BWD_LAUNCHES)
    got = kfa.flash_attention_bwd(q, k, v, o, g, 0.25, True)
    want = kfa.bwd_reference(q, k, v, o, g, 0.25, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    monkeypatch.setattr(kfa, "bwd_reference", None)
    meta = [torch.empty(t.shape, device="meta") for t in (q, k, v, o, g)]
    outs = kfa.flash_attention_bwd(*meta, 0.25, True)
    assert [t.device.type for t in outs] == ["meta"] * 3
    with pytest.raises(MXNetError):
        kfa.flash_attention_bwd(meta[0], k, v, o, g, 0.25, True)
    assert (kfa.LAUNCHES, kfa.BWD_LAUNCHES) == before


@pytest.mark.parametrize("shape,causal", [((1, 2, 64, 16), True),
                                          ((1, 2, 64, 16), False)])
def test_flash_gradient_through_lse_matches_jax(shape, causal, monkeypatch):
    """On the CPU ``FlashAttentionFn`` keeps the plain forward's row
    log-sum-exp (``dense_reference(return_lse=True)``) and its backward
    takes P = exp(s - lse) from it (``bwd_reference(lse=...)``), as the
    sm90 kernels do on the card; against ``jax.grad`` of the JAX package's
    flash attention (interpret mode) at 1e-4, float32."""
    seen = []
    real = kfa.bwd_reference

    def spy(*args):
        seen.append(args[7])
        return real(*args)

    monkeypatch.setattr(kfa, "bwd_reference", spy)
    arrays = _qkv(7, shape)
    scale = shape[-1] ** -0.5
    want = _jax_flash_grads(arrays, scale, causal, 64, jnp.float32)
    got = _port_flash_grads(arrays, scale, causal, 64, torch.float32)
    assert len(seen) == 1 and seen[0].shape == shape[:3] \
        and seen[0].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,causal", [(64, True), (64, False), (100, True)])
def test_lse_matches_jax_logsumexp(T, causal):
    """The row log-sum-exp the sm90 forward writes, in its plain version:
    ``jax.nn.logsumexp`` of the JAX package's scaled, masked scores."""
    q, k, v, _ = _qkv(11, (1, 2, T, 32))
    scale = 32 ** -0.5
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    o, lse = kfa.dense_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                 scale, causal, return_lse=True)
    assert lse.shape == (1, 2, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def _sm90_bwd_emulation(q, k, v, o, do, scale, causal, lse):
    """The sm90 backward's arithmetic: bf16 inputs, f32 scores times
    scale, P = exp(s - lse) in f32, P and dS rounded to bf16 before the
    products that take them from registers (dV, dK, dQ), f32 sums."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    s = kfa._scores(q, k, scale, causal)
    p = torch.exp(s - lse[..., None])
    delta = (gf * of).sum(-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - delta[..., None])
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", pb, gf)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, kf) * scale
    return [t.to(torch.bfloat16).float().numpy() for t in (dq, dk, dv)]


def _tf32(x):
    """float32 to TF32 by truncation, as the f32 kernels' ``tf32_trunc``."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm_3xtf32(eq, a, b):
    """a_hi b_lo + a_lo b_hi + a_hi b_hi over TF32 splits, each product of
    two TF32 values exact in float32: a float32 product as the f32 kernels
    form it."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


def _f32_bwd_emulation(q, k, v, o, do, scale, causal, lse):
    """The f32 backward's arithmetic (``csrc/flash_attention_bwd.cu``):
    every product in 3xTF32, P = exp(s - lse) in f32, zero where masked;
    dK and dV summed over q-tiles of 32 rows (16 at D = 128) in the order
    its dkdv kernel walks them, dQ over key tiles of the same size."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    bs = 16 if d == 128 else 32
    s = _mm_3xtf32("bhqd,bhkd->bhqk", q, k) * scale
    keep = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        keep = torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.tensor(0.))
    delta = (do * o).sum(-1)
    ds = p * (_mm_3xtf32("bhqd,bhkd->bhqk", do, v) - delta[..., None])
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for i in range(0, tq, bs):
        dv += _mm_3xtf32("bhqk,bhqd->bhkd", p[:, :, i:i + bs],
                         do[:, :, i:i + bs])
        dk += _mm_3xtf32("bhqk,bhqd->bhkd", ds[:, :, i:i + bs],
                         q[:, :, i:i + bs])
    for j in range(0, tk, bs):
        dq += _mm_3xtf32("bhqk,bhkd->bhqd", ds[..., j:j + bs],
                         k[:, :, j:j + bs])
    return [t.numpy() for t in (dq * scale, dk * scale, dv)]


@pytest.mark.parametrize("T,D,causal", [(128, 64, True), (128, 64, False),
                                        (64, 16, True)])
def test_f32_bwd_3xtf32_matches_jax(T, D, causal):
    """The f32 backward's 3xTF32 arithmetic, from the forward's row
    log-sum-exp, within the float32 pin (1e-4 relative, 1e-5 absolute) of
    ``jax.grad`` through the JAX package's flash attention (Pallas forward
    in interpret mode, ``_fa_bwd``)."""
    assert kfa._bwd_variant(torch.float32, D) == "f32"
    arrays = _qkv(13, (1, 2, T, D))
    scale = D ** -0.5
    want = _jax_flash_grads(arrays, scale, causal, 64, jnp.float32)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    o, lse = kfa.dense_reference(q, k, v, scale, causal, return_lse=True)
    got = _f32_bwd_emulation(q, k, v, o, g, scale, causal, lse)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_, w, rtol=1e-4, atol=1e-5)


def test_sm90_bwd_rounding_matches_jax():
    """bf16 P and dS in the second products are the roundings the
    reference lacks: the sm90 backward's arithmetic stays within the bf16
    pin of ``jax.grad`` through the JAX package's flash attention."""
    arrays = _qkv(7, (1, 2, 64, 32))
    scale = 32 ** -0.5
    want = _jax_flash_grads(arrays, scale, True, 64, jnp.bfloat16)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    o, lse = kfa.dense_reference(q, k, v, scale, True, return_lse=True)
    got = _sm90_bwd_emulation(q, k, v, o, g, scale, True, lse)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_, w, rtol=3e-2, atol=3e-2)
