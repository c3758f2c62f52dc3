"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do;
the port's wrapper runs its plain version because the tensors lie on the
CPU.  Tolerances: 1e-4 relative / 1e-5 absolute in float32 (the JAX
package's own pin for the flash forward against its dense reference), 3e-2
in bfloat16 (its bf16 pin: one bf16 rounding of outputs of order 1).

The kernels (``csrc/flash_attention_fwd_sm90.cu``, bf16 on the tensor
cores, and ``csrc/flash_attention_fwd.cu``, float32 in 3xTF32 form) run
only on the card; here test-local emulations of their arithmetic are held
against the JAX package, and the wrapper's routing is checked.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as kfa

CPU = mxt.cpu()
BF16 = torch.bfloat16


def _inputs(seed, shape, n=3):
    rs = np.random.RandomState(seed)
    return [rs.normal(0, 1, shape).astype(np.float32) for _ in range(n)]


def _both(op, arrays, **kw):
    jax_out = getattr(mxj.nd, op)(*[mxj.nd.array(a) for a in arrays], **kw)
    port_out = getattr(mxt.nd, op)(*[mxt.nd.array(a, ctx=CPU) for a in arrays],
                                   **kw)
    return jax_out.asnumpy(), mxt.nd.asnumpy(port_out)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal):
    want, got = _both("flash_attention", _inputs(0, (2, 3, 128, 32)),
                      causal=causal, block_q=32, block_k=32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("block", [64, 128])
def test_flash_attention_t100(block):
    """T=100: block 64 does not divide it (dense attention by the op's
    definition); block 128 clips to 100 and takes the kernel path."""
    want, got = _both("flash_attention", _inputs(1, (1, 2, 100, 16)),
                      causal=True, block_q=block, block_k=block)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_flash_attention_bf16():
    arrays = _inputs(3, (1, 2, 64, 32))
    want = mxj.nd.flash_attention(
        *[mxj.nd.array(a).astype("bfloat16") for a in arrays],
        block_q=32, block_k=32)
    got = mxt.nd.flash_attention(
        *[mxt.nd.array(a, ctx=CPU, dtype="bfloat16") for a in arrays],
        block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(mxt.nd.asnumpy(got).astype(np.float32),
                               want.asnumpy().astype(np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_multihead_attention_matches_jax(impl):
    qkv = _inputs(4, (2, 64, 3 * 32), n=1)
    want, got = _both("multihead_attention", qkv, num_heads=2, impl=impl)
    assert got.shape == (2, 64, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cpu_path_never_launches():
    before = kfa.LAUNCHES
    q, k, v = [torch.from_numpy(a) for a in _inputs(5, (1, 2, 64, 16))]
    out = kfa.flash_attention_fwd(q, k, v, 0.25, True)
    ref = kfa.dense_reference(q, k, v, 0.25, True)
    mxt.nd.multihead_attention(mxt.nd.array(_inputs(6, (1, 64, 48), 1)[0],
                                            ctx=CPU),
                               num_heads=2, impl="flash")
    assert kfa.LAUNCHES == before
    assert torch.equal(out, ref)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises.  Meta
    tensors (shape inference) get an empty meta output of O's shape with
    neither the plain version nor a kernel run; a meta tensor beside a CPU
    one is refused, not computed."""
    def plain(*a):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(kfa, "dense_reference", plain)
    before = kfa.LAUNCHES
    q = torch.empty((1, 2, 64, 16), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 2, 80, 16), device="meta", dtype=torch.bfloat16)
    out = kfa.flash_attention_fwd(q, k, k, 0.25, False)
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == q.dtype and kfa.LAUNCHES == before
    with pytest.raises(MXNetError):
        kfa.flash_attention_fwd(q, torch.empty(k.shape, dtype=k.dtype), k,
                                0.25, False)


def _sm90_emulation(q, k, v, scale, causal, bn=kfa.SM90_BLOCK_N):
    """The sm90 kernel's arithmetic: bf16 inputs, f32 scores times scale,
    the online softmax in f32 across k-tiles of ``bn`` keys (-1e30 above the
    causal diagonal, -inf past a ragged end), P rounded to bf16 before P V,
    f32 accumulation, l summed from the unrounded p, o cast to bf16."""
    tq, tk = q.shape[2], k.shape[2]
    pad = -tk % bn
    qf = q.float()
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
              for t in (k, v))
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(qf.shape)
    rows = torch.arange(tq)[:, None]
    for k0 in range(0, tk, bn):
        keys = torch.arange(k0, k0 + bn)[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bn]) * scale
        if causal:
            s = torch.where(keys > rows, torch.tensor(-1e30), s)
        s = torch.where(keys >= tk, torch.tensor(-float("inf")), s)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(BF16).float(), vf[:, :, k0:k0 + bn])
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(BF16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,D", [(128, 64), (128, 128), (100, 64), (256, 64)])
def test_sm90_rounding_matches_jax(T, D, causal):
    """bf16 P in P V is the one rounding the reference lacks: the kernel's
    arithmetic, at its own k-tile width, stays within the bf16 pin of the
    JAX kernel (interpret mode; T=100 clips the default block to 100 and
    takes the kernel; T=256 carries the online softmax across k-tiles)."""
    assert kfa._variant(BF16, D) == "sm90"
    arrays = _inputs(7, (1, 2, T, D))
    blk = 64 if T % 64 == 0 else 128
    want = mxj.nd.flash_attention(
        *[mxj.nd.array(a).astype("bfloat16") for a in arrays],
        causal=causal, block_q=blk, block_k=blk).asnumpy().astype(np.float32)
    got = _sm90_emulation(*[torch.from_numpy(a).to(BF16) for a in arrays],
                          D ** -0.5, causal)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


def tf32(x):
    """float32 to TF32 by truncation (the low 13 mantissa bits cleared), as
    the f32 kernels' ``tf32_trunc`` (``csrc/sm90.cuh``)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def mm_3xtf32(eq, a, b):
    """A float32 product as the f32 kernels form it: a_hi b_lo + a_lo b_hi +
    a_hi b_hi over the TF32 splits hi = tf32(x), lo = tf32(x - hi); each
    product of two TF32 values is exact in float32, the sums float32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


def _f32_emulation(q, k, v, scale, causal):
    """The f32 kernel's arithmetic: S = Q K^T in 3xTF32 times scale, the
    online softmax in f32 across k-tiles of 32 keys (-1e30 above the causal
    diagonal, -inf past a ragged end), each tile's P V in 3xTF32 from its
    split P, added to O's sum in f32; l summed from the unsplit p.
    Returns (O, lse)."""
    tq, tk = q.shape[2], k.shape[2]
    bn = 32
    kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, -tk % bn)) for t in (k, v))
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    rows = torch.arange(tq)[:, None]
    for k0 in range(0, tk, bn):
        keys = torch.arange(k0, k0 + bn)[None, :]
        s = mm_3xtf32("bhqd,bhkd->bhqk", q, kf[:, :, k0:k0 + bn]) * scale
        if causal:
            s = torch.where(keys > rows, torch.tensor(-1e30), s)
        s = torch.where(keys >= tk, torch.tensor(-float("inf")), s)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm_3xtf32(
            "bhqk,bhkd->bhqd", p, vf[:, :, k0:k0 + bn])
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None], m + torch.log(l)


@pytest.mark.parametrize("T,D,causal", [(128, 64, False), (128, 64, True),
                                        (64, 16, True), (100, 16, False)])
def test_f32_3xtf32_matches_jax(T, D, causal):
    """The f32 kernel's 3xTF32 arithmetic, at its own k-tile width, within
    the float32 pin of the JAX kernel (interpret mode; T=100 clips the
    default block to 100 and takes the kernel), and its row log-sum-exp
    within the same pin of the plain version's."""
    assert kfa._variant(torch.float32, D) == "f32"
    arrays = _inputs(9, (1, 2, T, D))
    blk = 64 if T % 64 == 0 else 128
    want = mxj.nd.flash_attention(
        *[mxj.nd.array(a) for a in arrays], causal=causal, block_q=blk,
        block_k=blk).asnumpy()
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got, lse = _f32_emulation(q, k, v, D ** -0.5, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    _, lse_ref = kfa.dense_reference(q, k, v, D ** -0.5, causal,
                                     return_lse=True)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,d,variant", [
    (BF16, 64, "sm90"), (BF16, 128, "sm90"), (BF16, 16, "f32"),
    (BF16, 32, "f32"), (torch.float32, 16, "f32"), (torch.float32, 32, "f32"),
    (torch.float32, 64, "f32"), (torch.float32, 128, "f32")])
def test_variant_routes_by_dtype_and_head_dim(dtype, d, variant):
    assert kfa._variant(dtype, d) == variant


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (BF16, 48)])
def test_variant_refuses_unsupported_inputs(dtype, d):
    with pytest.raises(MXNetError):
        kfa._variant(dtype, d)


@pytest.mark.parametrize("dtype,d,variant", [
    (BF16, 64, "sm90"), (BF16, 128, "sm90"), (BF16, 16, "f32"),
    (BF16, 32, "f32"), (torch.float32, 64, "f32"),
    (torch.float32, 128, "f32")])
def test_bwd_variant_routes_as_the_forward(dtype, d, variant):
    """K1b's sm90 kernel reads the row log-sum-exp that only the sm90
    forward writes, so the two are routed alike."""
    assert kfa._bwd_variant(dtype, d) == kfa._variant(dtype, d) == variant


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (BF16, 48)])
def test_bwd_variant_refuses_unsupported_inputs(dtype, d):
    with pytest.raises(MXNetError, match="flash_attention_bwd"):
        kfa._bwd_variant(dtype, d)


def test_lse_only_where_a_kernel_keeps_it():
    """``return_lse``: every kernel keeps lse now (both forward entries take
    its pointer, both backward entries read it); the plain version gives
    (O, lse) with O unchanged; meta tensors give an empty float32
    (B, H, Tq) lse."""
    assert kfa._ENTRIES["f32"].argtypes == kfa._ENTRIES["sm90"].argtypes
    assert kfa._BWD_ENTRIES["f32"].argtypes == \
        kfa._BWD_ENTRIES["sm90"].argtypes
    q, k, v = [torch.from_numpy(a) for a in _inputs(8, (1, 2, 64, 16))]
    o, lse = kfa.flash_attention_fwd(q, k, v, 0.25, True, return_lse=True)
    assert torch.equal(o, kfa.flash_attention_fwd(q, k, v, 0.25, True))
    assert lse.shape == (1, 2, 64) and lse.dtype == torch.float32
    meta = torch.empty((1, 2, 64, 16), device="meta", dtype=BF16)
    o, lse = kfa.flash_attention_fwd(meta, meta, meta, 0.25, True,
                                     return_lse=True)
    assert o.device.type == lse.device.type == "meta"
    assert lse.shape == (1, 2, 64) and lse.dtype == torch.float32
