"""The port's slice ops against the JAX package's, forward on the CPU.

One parametrised test: each case names an op, its numpy inputs and its
keyword arguments; both ``nd`` namespaces run it and every output is
compared.  Tolerance 1e-5 relative / 1e-6 absolute: the same float32 math
in another library, summed in another order.  Id-valued ops (take,
Embedding, one_hot, argmax) must agree exactly.  LayerNorm on rows that are
1 + 1e-4 * noise holds only about 6e-8 / 1e-4 = 6e-4 of relative precision
in x - mean, so that case compares at 1e-3 / 3e-4; a variance computed as
E[x^2] - E[x]^2 would miss it by order 1.
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

_rs = np.random.RandomState(0)


def _f(*shape):
    return _rs.normal(0, 1, shape).astype(np.float32)


_IDS = np.array([[-3.0, 0.0, 2.0], [7.9, 4.0, 100.0]], np.float32)
_FLAT_ROWS = (1.0 + 1e-4 * _rs.normal(0, 1, (3, 64))).astype(np.float32)

CASES = [
    ("Reshape", [_f(2, 3, 4)], {"shape": (0, -1)}),
    ("Reshape", [_f(2, 3, 4)], {"shape": (-1, 0)}),
    ("reshape", [_f(2, 3, 4)], {"shape": (0, 0, -4, 2, 2)}),
    ("Reshape", [_f(2, 3, 4)], {"shape": (-3, 0)}),
    ("expand_dims", [_f(3, 4)], {"axis": 0}),
    ("expand_dims", [_f(3, 4)], {"axis": -1}),
    ("slice_axis", [_f(2, 5, 3)], {"axis": 1, "begin": 1, "end": 3}),
    ("slice_axis", [_f(2, 5, 3)], {"axis": -1, "begin": 1, "end": None}),
    ("Concat", [_f(2, 3), _f(2, 2)], {"dim": 1}),
    ("concat", [_f(2, 3), _f(1, 3)], {"dim": 0}),
    ("broadcast_like", [_f(1, 4), _f(3, 4)], {}),
    ("broadcast_like", [_f(2, 1, 4), _f(2, 3, 4)], {}),
    ("take", [_f(6, 3), _IDS], {}),
    ("take", [_f(2, 6, 3), _IDS], {"axis": 1}),
    ("take", [_f(2, 3, 6), _IDS], {"axis": -1, "mode": "raise"}),
    ("Embedding", [_IDS, _f(6, 4)], {"input_dim": 6, "output_dim": 4}),
    ("one_hot", [_IDS], {"depth": 5}),
    ("one_hot", [_IDS], {"depth": 5, "on_value": 2.0, "off_value": -1.0}),
    ("FullyConnected", [_f(2, 3, 4), _f(5, 4), _f(5)],
     {"num_hidden": 5, "flatten": False}),
    ("FullyConnected", [_f(2, 3, 4), _f(5, 12), _f(5)], {"num_hidden": 5}),
    ("FullyConnected", [_f(2, 4), _f(5, 4)],
     {"num_hidden": 5, "no_bias": True}),
    ("LayerNorm", [_f(2, 3, 8), _f(8), _f(8)], {}),
    ("LayerNorm", [_f(4, 6), _f(4), _f(4)], {"axis": 0, "eps": 1e-3}),
    ("LayerNorm", [_FLAT_ROWS, _f(64), _f(64)], {}, (1e-3, 3e-4)),
    ("Activation", [_f(3, 4)], {"act_type": "relu"}),
    ("Activation", [_f(2, 3, 5)], {"act_type": "relu"}),
    ("Dropout", [_f(3, 4)], {"p": 0.5}),
    ("argmax", [_f(3, 7)], {"axis": -1, "keepdims": True}),
    ("argmax", [_f(3, 7)], {"axis": 0}),
    ("argmax", [np.array([[1.0, 3.0, 3.0, 2.0]], np.float32)],
     {"axis": 1, "keepdims": True}),
    ("argmax", [_f(3, 7)], {}),
    ("broadcast_add", [_f(2, 3), _f(1, 3)], {}),
    ("broadcast_sub", [_f(2, 3), _f(2, 1)], {}),
    ("broadcast_mul", [_f(2, 3), _f(1, 3)], {}),
    ("broadcast_div", [_f(2, 3), _f(1, 3) + 4.0], {}),
    ("elemwise_add", [_f(2, 3), _f(2, 3)], {}),
    ("elemwise_mul", [_f(2, 3), _f(2, 3)], {}),
    ("_plus_scalar", [_f(2, 3)], {"scalar": 1.5}),
    ("_minus_scalar", [_f(2, 3)], {"scalar": 1.5}),
    ("_rminus_scalar", [_f(2, 3)], {"scalar": 1.5}),
    ("_mul_scalar", [_f(2, 3)], {"scalar": -2.0}),
    ("_div_scalar", [_f(2, 3)], {"scalar": 3.0}),
    ("_rdiv_scalar", [_f(2, 3) + 4.0], {"scalar": 3.0}),
    ("arange_like", [_f(2, 5)], {"axis": 1}),
    ("arange_like", [_f(2, 5)], {"start": 1.0, "step": 0.5}),
    ("flash_attention", [_f(1, 2, 32, 16) for _ in range(3)],
     {"causal": True}),
    ("multihead_attention", [_f(2, 16, 3 * 16)],
     {"num_heads": 2, "impl": "dense"}),
]


def _ids(case):
    op, _, kw = case[:3]
    return op + "-" + "-".join(f"{k}={v}" for k, v in sorted(kw.items()))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_op_matches_jax(case):
    op, arrays, kw = case[:3]
    rtol, atol = case[3] if len(case) > 3 else (1e-5, 1e-6)
    want = getattr(mxj.nd, op)(*[mxj.nd.array(a) for a in arrays], **kw)
    got = getattr(mxt.nd, op)(*[mxt.nd.array(a, ctx=mxt.cpu())
                                for a in arrays], **kw)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = mxt.nd.asnumpy(g), w.asnumpy()
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=rtol, atol=atol)
