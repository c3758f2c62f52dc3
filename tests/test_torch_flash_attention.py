"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do;
the port's wrapper runs its plain version because the tensors lie on the
CPU.  Tolerances: 1e-4 relative / 1e-5 absolute in float32 (the JAX
package's own pin for the flash forward against its dense reference), 3e-2
in bfloat16 (its bf16 pin: one bf16 rounding of outputs of order 1).

The bf16 tensor-core kernel (``csrc/flash_attention_fwd_sm90.cu``) runs only
on the card; here a test-local emulation of its rounding points is held
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
