"""The port alone reproduces the committed TransformerLM golden logits.

The net is built as the JAX package's golden case (seed 0, Xavier gaussian
'in' magnitude 2, tokens from RandomState(42)), rebuilt with the port's
initializer and deferred-init order; no JAX code runs.  Tolerance: the
fixture's own 1e-4.
"""
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "golden", "transformer_lm.npz")


@pytest.mark.parametrize("attn_type", ["flash", "dense"])
def test_golden_transformer_lm(attn_type):
    mxt.random.seed(0)
    net = TransformerLM(vocab=32, dim=32, num_layers=2, num_heads=4,
                        max_len=16, attn_type=attn_type)
    net.initialize(mxt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2), ctx=mxt.cpu())
    rs = np.random.RandomState(42)
    x = mxt.nd.array(rs.randint(0, 32, (2, 16)).astype(np.float32),
                     ctx=mxt.cpu())
    got = mxt.nd.asnumpy(net(x))
    want = np.load(FIXTURE)["logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
