"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do;
the port's wrapper runs its plain version because the tensors lie on the
CPU.  Tolerances: 1e-4 relative / 1e-5 absolute in float32 (the JAX
package's own pin for the flash forward against its dense reference), 3e-2
in bfloat16 (its bf16 pin: one bf16 rounding of outputs of order 1).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as kfa

CPU = mxt.cpu()


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


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Off the CPU the wrapper launches the kernel or raises; a tensor on
    another device (here 'meta') is refused, not computed."""
    q = torch.empty((1, 2, 64, 16), device="meta")
    with pytest.raises(MXNetError):
        kfa.flash_attention_fwd(q, q, q, 0.25, False)
