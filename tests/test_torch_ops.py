"""The port's slice ops against the JAX package's, forward on the CPU.

One parametrised test: each case names an op, its numpy inputs and its
keyword arguments; both ``nd`` namespaces run it and every output is
compared.  Tolerance 1e-5 relative / 1e-6 absolute: the same float32 math
in another library, summed in another order.  Id-valued ops (take,
Embedding, one_hot, argmax, argmin, the comparisons) must agree exactly.
The ``linalg_*`` cases take symmetric positive definite matrices (and
their Cholesky factors), batched over a leading axis; the creation ops
``_full`` and ``_eye`` take their ``ctx`` as a graph file writes it.  LayerNorm on rows that are
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


def _r(*shape):
    """Small integers as float32: comparisons meet ties, logical ops
    zeros."""
    return np.round(_rs.normal(0, 1.2, shape)).astype(np.float32)


def _spd(n, batch=2):
    m = _rs.normal(0, 1, (batch, n, n))
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


_SPD = _spd(3)
_CHOL = np.linalg.cholesky(_SPD.astype(np.float64)).astype(np.float32)
_DIVISORS = np.array([[2.0, -2.0, 1.5]], np.float32)
_NON_ZERO = (np.sign(_f(2, 3)) * (1.0 + np.abs(_f(2, 3)))).astype(np.float32)

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
    # -- the core op surface: elementwise ---------------------------------
    ("clip", [_f(3, 4)], {"a_min": -0.5, "a_max": 0.5}),
    ("_copy", [_f(2, 3)], {}),
    ("identity", [_f(2, 3)], {}),
    ("add_n", [_f(2, 3), _f(2, 3), _f(2, 3)], {}),
    ("ElementWiseSum", [_f(2, 3), _f(2, 3)], {}),
    ("smooth_l1", [_f(3, 4)], {"scalar": 1.5}),
    ("broadcast_greater", [_r(2, 3), _r(1, 3)], {}),
    ("broadcast_greater_equal", [_r(2, 3), _r(1, 3)], {}),
    ("broadcast_lesser", [_r(2, 3), _r(2, 1)], {}),
    ("broadcast_lesser_equal", [_r(2, 3), _r(1, 3)], {}),
    ("broadcast_not_equal", [_r(2, 3), _r(1, 3)], {}),
    ("_greater", [_r(2, 3), _r(2, 3)], {}),
    ("broadcast_logical_and", [_r(2, 3), _r(1, 3)], {}),
    ("broadcast_logical_or", [_r(2, 3), _r(1, 3)], {}),
    ("broadcast_logical_xor", [_r(2, 3), _r(1, 3)], {}),
    ("broadcast_mod", [_f(2, 3) * 3, _DIVISORS], {}),
    ("_mod", [_f(2, 3) * 3, _DIVISORS], {}),
    ("_mod_scalar", [_f(2, 3) * 3], {"scalar": 2.0}),
    ("_mod_scalar", [_f(2, 3) * 3], {"scalar": -1.5}),
    ("_rmod_scalar", [_NON_ZERO], {"scalar": 5.0}),
    ("_greater_scalar", [_r(2, 3)], {"scalar": 0.0}),
    ("_greater_equal_scalar", [_r(2, 3)], {"scalar": 0.0}),
    ("_lesser_scalar", [_r(2, 3)], {"scalar": 1.0}),
    ("_lesser_equal_scalar", [_r(2, 3)], {"scalar": 1.0}),
    ("_not_equal_scalar", [_r(2, 3)], {"scalar": 0.0}),
    # -- matrix -----------------------------------------------------------
    ("dot", [_f(3, 4), _f(4, 5)], {}),
    ("dot", [_f(4, 3), _f(4, 5)], {"transpose_a": True}),
    ("dot", [_f(3, 4), _f(5, 4)], {"transpose_b": True}),
    ("dot", [_f(2, 3, 4), _f(4, 5)], {}),
    ("dot", [_f(3, 4, 2), _f(4, 5)], {"transpose_a": True}),
    ("dot", [_f(2, 4), _f(4, 3, 5)], {}),
    ("dot", [_f(4), _f(4)], {}),
    ("batch_dot", [_f(2, 3, 4), _f(2, 4, 5)], {}),
    ("batch_dot", [_f(2, 4, 3), _f(2, 5, 4)],
     {"transpose_a": True, "transpose_b": True}),
    ("transpose", [_f(2, 3, 4)], {"axes": (1, 0, 2)}),
    ("transpose", [_f(2, 3, 4)], {}),
    ("SwapAxis", [_f(2, 3, 4)], {"dim1": 0, "dim2": 2}),
    ("swapaxes", [_f(2, 3, 4)], {"dim1": 1, "dim2": 2}),
    ("squeeze", [_f(2, 1, 3, 1)], {"axis": (1,)}),
    ("squeeze", [_f(2, 1, 3, 1)], {}),
    ("stack", [_f(2, 3), _f(2, 3), _f(2, 3)], {"axis": 1}),
    ("SliceChannel", [_f(2, 6, 3)], {"num_outputs": 3}),
    ("split", [_f(2, 6, 3)], {"num_outputs": 3, "axis": 2,
                             "squeeze_axis": True}),
    ("slice", [_f(4, 5, 6)], {"begin": (1, None, 0), "end": (3, 4, None)}),
    ("slice", [_f(4, 5, 6)], {"begin": (None, 4), "end": (None, 0),
                              "step": (2, -2)}),
    ("crop", [_f(4, 5)], {"begin": (-3, 1), "end": (None, -1)}),
    ("slice_like", [_f(4, 5, 6), _f(2, 3, 9)], {}),
    ("slice_like", [_f(4, 5, 6), _f(2, 3, 4)], {"axes": (0, 2)}),
    ("broadcast_to", [_f(1, 3, 1)], {"shape": (2, 0, 4)}),
    ("broadcast_axis", [_f(1, 3, 1)], {"axis": (0, 2), "size": (2, 5)}),
    ("reverse", [_f(3, 4)], {"axis": (0,)}),
    ("flip", [_f(3, 4, 2)], {"axis": (1, 2)}),
    ("Pad", [_f(2, 3, 4, 5)], {"mode": "constant",
                               "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                               "constant_value": 1.5}),
    ("pad", [_f(2, 3, 4, 5)], {"mode": "edge",
                               "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}),
    ("Pad", [_f(2, 3, 4, 5)], {"mode": "reflect",
                               "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    ("gather_nd", [_f(3, 4, 2), np.array([[0, 2, 1], [3, 0, 1]], np.float32)],
     {}),
    ("scatter_nd", [_f(3), np.array([[0, 2, 0], [1, 3, 1]], np.float32)],
     {"shape": (3, 4)}),
    ("batch_take", [_f(3, 4), np.array([0, 3, 1], np.float32)], {}),
    ("zeros_like", [_f(2, 3)], {}),
    ("ones_like", [_f(2, 3)], {}),
    ("linalg_gemm", [_f(2, 3, 4), _f(2, 4, 5), _f(2, 3, 5)],
     {"alpha": 0.5, "beta": 2.0}),
    ("linalg_gemm", [_f(2, 4, 3), _f(2, 5, 4), _f(2, 3, 5)],
     {"transpose_a": True, "transpose_b": True}),
    ("linalg_gemm2", [_f(2, 3, 4), _f(2, 5, 4)],
     {"transpose_b": True, "alpha": 2.0}),
    ("linalg_potrf", [_SPD], {}),
    ("linalg_potri", [_CHOL], {}, (1e-4, 1e-5)),
    ("linalg_trsm", [_CHOL, _f(2, 3, 4)], {"alpha": 0.5}, (1e-4, 1e-5)),
    ("linalg_trsm", [_CHOL, _f(2, 3, 4)], {"transpose": True},
     (1e-4, 1e-5)),
    ("linalg_trsm", [_CHOL, _f(2, 4, 3)], {"rightside": True},
     (1e-4, 1e-5)),
    ("linalg_trmm", [_CHOL, _f(2, 3, 4)], {"alpha": 2.0}),
    ("linalg_trmm", [_CHOL, _f(2, 4, 3)],
     {"rightside": True, "transpose": True}),
    ("linalg_trmm", [_SPD, _f(2, 3, 4)], {"lower": False}),
    ("linalg_sumlogdiag", [_CHOL], {}),
    ("linalg_syrk", [_f(2, 3, 4)], {"alpha": 0.5}),
    ("linalg_syrk", [_f(2, 3, 4)], {"transpose": True}),
    # -- reductions, creation and nn ---------------------------------------
    ("norm", [_f(3, 4)], {}),
    ("norm", [_f(2, 3, 4)], {"axis": (1, 2), "keepdims": True}),
    ("norm", [_f(2, 3, 4)], {"ord": 1, "axis": (0,)}),
    ("argmin", [_f(3, 7)], {"axis": -1, "keepdims": True}),
    ("argmin", [np.array([[3.0, 1.0, 1.0, 2.0]], np.float32)], {"axis": 1}),
    ("argmin", [_f(3, 7)], {}),
    ("argmax_channel", [_f(3, 7)], {}),
    ("_full", [], {"shape": (2, 3), "value": 1.5, "ctx": "cpu(0)"}),
    ("_eye", [], {"N": 3, "M": 4, "k": 1, "ctx": "cpu(0)"}),
    ("_eye", [], {"N": 3, "k": -1, "dtype": "int32", "ctx": "cpu(0)"}),
    ("softmax_cross_entropy", [_f(4, 5), np.array([0, 4, 2, 1], np.float32)],
     {}),
    ("SoftmaxActivation", [_f(2, 3, 4)], {}),
    ("SoftmaxActivation", [_f(2, 3, 4, 2)], {"mode": "channel"}),
    ("L2Normalization", [_f(2, 3, 4)], {}),
    ("L2Normalization", [_f(2, 3, 4)], {"mode": "channel"}),
    ("L2Normalization", [_f(2, 3, 4, 2)], {"mode": "spatial", "eps": 1e-3}),
    ("SVMOutput", [_f(4, 5), np.array([0, 4, 2, 1], np.float32)], {}),
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
