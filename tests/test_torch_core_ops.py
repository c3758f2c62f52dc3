"""The port's core op and ``nd`` surface against the JAX package's, on the
CPU: gradients of the differentiable ops, edge semantics, ``linalg_*`` on
symmetric positive definite inputs, the ``nd`` free functions, ``nd.random``
(shapes, dtypes, moments, repeatability), the initializers, ``gluon.Constant``,
``MultiHeadAttention``, ``gluon.utils``, ``gluon.data.vision`` and one DCGAN
training step.

The same numpy inputs go through ``mxnet_tpu`` and ``mxnet_tpu_torch``
(``ctx=cpu()``).  Tolerances: gradients 1e-5 relative / 1e-6 absolute (the
same float32 math in another library, summed in another order), the
triangular solves and Cholesky gradients 1e-4 / 1e-5 (a solve's rounding
grows with the condition number); ``MultiHeadAttention`` 1e-5; one DCGAN
step every parameter within 1e-4 of its largest change (Adam's step divides
by sqrt(v), which amplifies the gradients' last-digit differences);
``clip_global_norm`` 1e-6 relative (float32 sums per array, in another
order).  Random draws cannot equal the JAX package's bit for bit (a jax
PRNG key against torch's generators): each package's mean and variance of
20,000 draws lie within 5 standard errors of the distribution's.
"""
import gzip
import hashlib
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

CPU = mxt.cpu()


class _Jax:
    mx = mxj

    @staticmethod
    def array(a):
        return mxj.nd.array(a)

    @staticmethod
    def attach(x):
        x.attach_grad()
        return x

    @staticmethod
    def grad(x):
        return x.grad.asnumpy()

    @staticmethod
    def numpy(x):
        return x.asnumpy()

    @staticmethod
    def cpu():
        return mxj.cpu()


class _Port:
    mx = mxt

    @staticmethod
    def array(a):
        return mxt.nd.array(a, ctx=CPU)

    @staticmethod
    def attach(x):
        return mxt.nd.attach_grad(x)

    @staticmethod
    def grad(x):
        return mxt.nd.asnumpy(mxt.nd.grad(x))

    @staticmethod
    def numpy(x):
        return mxt.nd.asnumpy(x)

    @staticmethod
    def cpu():
        return mxt.cpu()


def _close(got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               rtol=rtol, atol=atol)


_rs = np.random.RandomState(11)


def _f(*shape):
    return _rs.normal(0, 1, shape).astype(np.float32)


def _spd(n, batch=2):
    m = _rs.normal(0, 1, (batch, n, n))
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


_SPD = _spd(3)
_CHOL = np.linalg.cholesky(_SPD.astype(np.float64)).astype(np.float32)
_POS = (0.5 + np.abs(_f(2, 3))).astype(np.float32)
_NON_ZERO = (np.sign(_f(2, 3)) * (0.5 + np.abs(_f(2, 3)))).astype(np.float32)
_LIN = (1e-4, 1e-5)

# (op, numpy inputs, kwargs, positions of the inputs to differentiate,
#  tolerance)
GRAD_CASES = [
    ("clip", [_f(3, 4)], {"a_min": -0.5, "a_max": 0.5}, (0,)),
    ("_copy", [_f(2, 3)], {}, (0,)),
    ("add_n", [_f(2, 3), _f(2, 3), _f(2, 3)], {}, (0, 1, 2)),
    ("smooth_l1", [_f(3, 4)], {"scalar": 1.5}, (0,)),
    ("broadcast_mod", [_f(2, 3) * 3, np.array([[2.0, -2.0, 1.5]], np.float32)],
     {}, (0, 1)),
    ("_mod_scalar", [_f(2, 3) * 3], {"scalar": -1.5}, (0,)),
    ("_rmod_scalar", [_NON_ZERO], {"scalar": 5.0}, (0,)),
    ("broadcast_power", [_POS, _f(1, 3)], {}, (0, 1)),
    ("_power_scalar", [_NON_ZERO], {"scalar": 3.0}, (0,)),
    ("broadcast_hypot", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("cbrt", [_NON_ZERO], {}, (0,)),
    ("broadcast_greater", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("broadcast_greater_equal", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("broadcast_lesser", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("broadcast_lesser_equal", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("broadcast_not_equal", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("broadcast_logical_and", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("broadcast_logical_or", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("broadcast_logical_xor", [_f(2, 3), _f(1, 3)], {}, (0, 1)),
    ("_greater_scalar", [_f(2, 3)], {"scalar": 0.0}, (0,)),
    ("_greater_equal_scalar", [_f(2, 3)], {"scalar": 0.0}, (0,)),
    ("_lesser_scalar", [_f(2, 3)], {"scalar": 0.0}, (0,)),
    ("_lesser_equal_scalar", [_f(2, 3)], {"scalar": 0.0}, (0,)),
    ("_not_equal_scalar", [_f(2, 3)], {"scalar": 0.0}, (0,)),
    ("dot", [_f(3, 4, 2), _f(4, 5)], {"transpose_a": True}, (0, 1)),
    ("dot", [_f(2, 3, 4), _f(4, 5)], {}, (0, 1)),
    ("batch_dot", [_f(2, 4, 3), _f(2, 4, 5)], {"transpose_a": True}, (0, 1)),
    ("transpose", [_f(2, 3, 4)], {"axes": (2, 0, 1)}, (0,)),
    ("SwapAxis", [_f(2, 3, 4)], {"dim1": 0, "dim2": 2}, (0,)),
    ("squeeze", [_f(2, 1, 3)], {"axis": (1,)}, (0,)),
    ("stack", [_f(2, 3), _f(2, 3)], {"axis": 2}, (0, 1)),
    ("SliceChannel", [_f(2, 6, 3)], {"num_outputs": 3, "squeeze_axis": False},
     (0,)),
    ("slice", [_f(4, 5, 6)], {"begin": (None, 4), "end": (None, 0),
                              "step": (2, -2)}, (0,)),
    ("slice_like", [_f(4, 5, 6), _f(2, 3, 4)], {"axes": (0, 2)}, (0,)),
    ("broadcast_to", [_f(1, 3, 1)], {"shape": (2, 0, 4)}, (0,)),
    ("broadcast_axis", [_f(1, 3, 1)], {"axis": (0, 2), "size": (2, 5)}, (0,)),
    ("reverse", [_f(3, 4)], {"axis": (1,)}, (0,)),
    ("Pad", [_f(2, 3, 4, 5)], {"mode": "edge",
                               "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}, (0,)),
    ("Pad", [_f(2, 3, 4, 5)], {"mode": "reflect",
                               "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}, (0,)),
    ("gather_nd", [_f(3, 4), np.array([[0, 2, 0], [1, 3, 1]], np.float32)],
     {}, (0,)),
    ("scatter_nd", [_f(3), np.array([[0, 2, 0], [1, 3, 1]], np.float32)],
     {"shape": (3, 4)}, (0,)),
    ("batch_take", [_f(3, 4), np.array([0, 3, 1], np.float32)], {}, (0,)),
    ("zeros_like", [_f(2, 3)], {}, (0,)),
    ("ones_like", [_f(2, 3)], {}, (0,)),
    ("linalg_gemm", [_f(2, 3, 4), _f(2, 4, 5), _f(2, 3, 5)],
     {"alpha": 0.5, "beta": 2.0}, (0, 1, 2)),
    ("linalg_gemm2", [_f(2, 4, 3), _f(2, 4, 5)], {"transpose_a": True},
     (0, 1)),
    ("linalg_potrf", [_SPD], {}, (0,), _LIN),
    ("linalg_potri", [_CHOL], {}, (0,), _LIN),
    ("linalg_trsm", [_CHOL, _f(2, 3, 4)], {"alpha": 0.5}, (0, 1), _LIN),
    ("linalg_trsm", [_CHOL, _f(2, 4, 3)], {"rightside": True,
                                           "transpose": True}, (0, 1), _LIN),
    ("linalg_trmm", [_SPD, _f(2, 4, 3)], {"rightside": True, "lower": False},
     (0, 1)),
    ("linalg_sumlogdiag", [_CHOL], {}, (0,)),
    ("linalg_syrk", [_f(2, 3, 4)], {"transpose": True}, (0,)),
    ("norm", [_f(2, 3, 4)], {"axis": (1, 2)}, (0,)),
    ("softmax_cross_entropy", [_f(4, 5), np.array([0, 4, 2, 1], np.float32)],
     {}, (0,)),
    ("SoftmaxActivation", [_f(2, 3, 4)], {"mode": "channel"}, (0,)),
    ("L2Normalization", [_f(2, 3, 4)], {"mode": "instance"}, (0,)),
    ("SVMOutput", [_f(4, 5) * 2, np.array([0, 4, 2, 1], np.float32)],
     {"use_linear": True, "margin": 0.5}, (0,)),
]


def _case_id(case):
    op, _, kw = case[:3]
    return op + "-" + "-".join(f"{k}={v}" for k, v in sorted(kw.items()))


def _op_grads(api, op, arrays, kw, wrt):
    """The op's outputs and the gradients of sum(out * w) over its outputs
    (w a fixed seeded weight shaped like each output) with respect to the
    inputs at ``wrt``."""
    xs = [api.array(a) for a in arrays]
    for i in wrt:
        api.attach(xs[i])
    rs = np.random.RandomState(1)
    with api.mx.autograd.record():
        out = getattr(api.mx.nd, op)(*xs, **kw)
        outs = out if isinstance(out, (list, tuple)) else [out]
        loss = None
        for o in outs:
            w = api.array(rs.normal(size=o.shape).astype(np.float32))
            term = (o * w).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return [api.numpy(o) for o in outs] + [api.grad(xs[i]) for i in wrt]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[_case_id(c) for c in GRAD_CASES])
def test_gradient_matches_jax(case):
    op, arrays, kw, wrt = case[:4]
    rtol, atol = case[4] if len(case) > 4 else (1e-5, 1e-6)
    want = _op_grads(_Jax, op, arrays, kw, wrt)
    got = _op_grads(_Port, op, arrays, kw, wrt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, rtol, atol)


# -- edge semantics ------------------------------------------------------------
def _clip_at_bounds(api):
    """jnp.clip's gradient at a bound is 0.5 (a max then a min, each
    splitting its tie)."""
    x = api.attach(api.array(np.array([-1.0, 0.0, 0.5, 1.0, 2.0], np.float32)))
    with api.mx.autograd.record():
        y = api.mx.nd.clip(x, a_min=0.0, a_max=1.0)
    y.backward()
    g = api.grad(x)
    np.testing.assert_array_equal(g, [0.0, 0.5, 1.0, 0.5, 0.0])
    return [api.numpy(y), g]


def _norm_at_zero(api):
    """sqrt(sum(x^2)) has a NaN gradient at 0."""
    x = api.attach(api.array(np.zeros(3, np.float32)))
    with api.mx.autograd.record():
        y = api.mx.nd.norm(x)
    y.backward()
    assert np.isnan(api.grad(x)).all()
    return [api.numpy(y), api.grad(x)]


def _argmin_dtype(api):
    nd = api.mx.nd
    x = api.array(np.array([[3.0, 1.0, 2.0], [0.0, 5.0, 0.0]], np.float32))
    ints = api.array(np.array([4, 2, 9], np.int32))
    return [api.numpy(nd.argmin(x, axis=1)), api.numpy(nd.argmin(x)),
            api.numpy(nd.argmin(ints)), api.numpy(nd.argmin(ints, axis=0))]


def _mod_sign(api):
    """mod takes the divisor's sign: [-3, 3] mod [2, -2] is [1, -1]."""
    nd = api.mx.nd
    a = api.array(np.array([-3.0, 3.0], np.float32))
    b = api.array(np.array([2.0, -2.0], np.float32))
    out = [api.numpy(nd.broadcast_mod(a, b)),
           api.numpy(nd._mod_scalar(a, scalar=-2.0)),
           api.numpy(nd._rmod_scalar(b, scalar=-3.0)),
           api.numpy(nd.modulo(a, b)), api.numpy(nd.modulo(7.0, b))]
    np.testing.assert_array_equal(out[0], [1.0, -1.0])
    return out


def _dot_transpose_a_nd(api):
    """transpose_a on an N-d lhs moves its last axis to the front: (3, 4,
    2) against (4, 5) gives (2, 3, 5) (upstream MXNet contracts over the
    first axis)."""
    rs = np.random.RandomState(5)
    a = api.array(rs.normal(size=(3, 4, 2)).astype(np.float32))
    b = api.array(rs.normal(size=(4, 5)).astype(np.float32))
    out = api.numpy(api.mx.nd.dot(a, b, transpose_a=True))
    assert out.shape == (2, 3, 5)
    return [out]


_EDGES = [_clip_at_bounds, _norm_at_zero, _argmin_dtype, _mod_sign,
          _dot_transpose_a_nd]


@pytest.mark.parametrize("case", _EDGES, ids=[c.__name__[1:] for c in _EDGES])
def test_edge_semantics_match_jax(case):
    want = case(_Jax)
    got = case(_Port)
    for g, w in zip(got, want):
        _close(g, w)


# -- nd functions ----------------------------------------------------------------
def _nd_functions(api):
    nd = api.mx.nd
    x = api.array(np.array([[1.0, -2.0, 3.0], [0.5, 2.0, -1.0]], np.float32))
    y = api.array(np.array([[2.0, -2.0, 1.0]], np.float32))
    out = [nd.ones((2, 3)), nd.ones(4, dtype="int32"), nd.full((2, 2), 1.5),
           nd.empty((2, 3)), nd.arange(5), nd.arange(1, 7, 2, repeat=2),
           nd.arange(0, 1, 0.25), nd.eye(3), nd.eye(3, 4, k=-1),
           nd.from_numpy(np.arange(6, dtype=np.int32).reshape(2, 3)),
           nd.moveaxis(api.array(np.zeros((2, 3, 4), np.float32)), 0, -1),
           nd.concatenate([x, y], axis=0)]
    for fn in ("add", "multiply", "true_divide", "minimum", "hypot", "equal",
               "not_equal", "greater_equal", "lesser"):
        out.append(getattr(nd, fn)(x, y))
    # a number on either side; comparisons mirror theirs on the left
    for fn in ("subtract", "divide", "power", "maximum", "greater",
               "lesser_equal", "modulo"):
        f = getattr(nd, fn)
        base = nd.abs(x) + 0.5 if fn == "power" else x
        out += [f(base, y), f(base, 2.0), f(2.0, y)]
    hot = nd.zeros((3, 4))
    nd.onehot_encode(api.array(np.array([1.0, 3.0, 0.0], np.float32)), hot)
    out.append(hot)
    nd.waitall()
    return [api.numpy(o) for o in out] + [
        nd.maximum(2.0, 3.0), nd.add(2, 3), nd.power(2.0, 3.0)]


def test_nd_functions_match_jax():
    want = _nd_functions(_Jax)
    with mxt.cpu():
        got = _nd_functions(_Port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            _close(g, w)
        else:
            assert g == w


def test_the_surface_is_exported():
    """The names the JAX package's users call, at the same places."""
    for name in ("ones", "full", "empty", "arange", "eye", "from_numpy",
                 "from_dlpack", "onehot_encode", "moveaxis", "concatenate",
                 "waitall", "add", "subtract", "multiply", "divide", "power",
                 "maximum", "minimum", "hypot", "equal", "not_equal",
                 "greater", "greater_equal", "lesser", "lesser_equal",
                 "modulo", "true_divide", "random", "linalg"):
        assert hasattr(mxt.nd, name) and hasattr(mxj.nd, name), name
    for name in ("Constant", "Orthogonal", "MSRAPrelu", "Bilinear",
                 "LSTMBias", "FusedRNN", "Mixed", "Load"):
        assert hasattr(mxt.init, name) and hasattr(mxt.initializer, name)
    assert mxt.gluon.nn.MultiHeadAttention and mxt.gluon.Constant
    assert mxt.random.uniform is mxt.nd.random.uniform
    assert set(dir(mxj.nd.linalg)) >= {"gemm", "potrf", "syrk"}
    assert {n for n in dir(mxj.nd.linalg) if not n.startswith("_")} - {
        "invoke"} <= set(dir(mxt.nd.linalg))
    assert {n for n in dir(mxj.nd.random) if not n.startswith("_")} - {
        "invoke", "register", "NDArray", "annotations"} <= set(
            dir(mxt.nd.random))


def test_from_dlpack_shares_memory():
    src = torch.arange(6, dtype=torch.float32)
    out = mxt.nd.from_dlpack(torch.utils.dlpack.to_dlpack(src))
    src[0] = 7.0
    assert out[0].item() == 7.0 and out.dtype == torch.float32


# -- nd.random -------------------------------------------------------------------
N_DRAWS = 20000
_SAMPLE_PARAMS = {"uniform": ((-1.0, 2.0), (3.0, 3.5)),
                  "normal": ((1.0, 0.0), (2.0, 0.5)),
                  "gamma": ((2.0, 0.5), (1.5, 2.0)),
                  "exponential": ((2.0, 0.5),),
                  "poisson": ((3.0, 8.0),),
                  "negative_binomial": ((3.0, 1.0), (0.4, 0.7)),
                  "generalized_negative_binomial": ((2.0, 6.0), (0.5, 0.2))}
_MOMENTS = {
    "uniform": lambda a, b: ((a + b) / 2, (b - a) ** 2 / 12),
    "normal": lambda a, b: (a, b * b),
    "gamma": lambda a, b: (a * b, a * b * b),
    "exponential": lambda a, b=None: (1 / a, 1 / a ** 2),
    "poisson": lambda a, b=None: (a, a),
    "negative_binomial": lambda a, b: (a * (1 - b) / b, a * (1 - b) / b ** 2),
    "generalized_negative_binomial": lambda a, b: (a, a + b * a * a),
    "randint": lambda a, b: ((a + b - 1) / 2, ((b - a) ** 2 - 1) / 12)}


def _draws(api):
    """Every random op once: (name, numpy draws, the distribution's mean
    and variance, or None for the calls that check shape and dtype)."""
    r = api.mx.nd.random
    nd = api.mx.nd
    n = (N_DRAWS,)
    rows = [("uniform", r.uniform(-1.0, 3.0, shape=n), -1.0, 3.0),
            ("normal", r.normal(1.0, 2.0, shape=n), 1.0, 2.0),
            ("gamma", r.gamma(2.0, 1.5, shape=n), 2.0, 1.5),
            ("exponential", r.exponential(2.0, shape=n), 2.0, None),
            ("poisson", r.poisson(3.0, shape=n), 3.0, None),
            ("negative_binomial", r.negative_binomial(3, 0.4, shape=n),
             3.0, 0.4),
            ("generalized_negative_binomial",
             r.generalized_negative_binomial(2.0, 0.5, shape=n), 2.0, 0.5),
            ("randint", r.randint(-3, 7, shape=n), -3, 7)]
    rows = [(name, api.numpy(d), *_MOMENTS[name](a, b))
            for name, d, a, b in rows]
    for name, params in _SAMPLE_PARAMS.items():
        tensors = [api.array(np.array(p, np.float32)) for p in params]
        draws = api.numpy(getattr(nd, "_sample_" + name)(*tensors, shape=n))
        rows += [("_sample_" + name, draws[i],
                  *_MOMENTS[name](*[p[i] for p in params]))
                 for i in range(len(params[0]))]
    probs = api.array(np.array([0.2, 0.3, 0.5], np.float32))
    rows.append(("multinomial", api.numpy(r.multinomial(probs, shape=n)),
                 1.3, 2.3 - 1.3 ** 2))
    mu = api.array(np.array([0.0, 5.0], np.float32))
    sigma = api.array(np.array([1.0, 2.0], np.float32))
    rows2 = api.array(np.array([[0.2, 0.8], [0.5, 0.5]], np.float32))
    # the JAX package's nd.random.uniform raises on tensor parameters
    # (ROADMAP.md section 3): its op, _sample_uniform, gives the shape
    uniform = nd._sample_uniform if api is _Jax else r.uniform
    for d in (uniform(mu, mu + 1, shape=(4,)), r.normal(mu, sigma, shape=(2,)),
              r.randn(2, 3), r.randint(0, 5, shape=(2,), dtype="int64"),
              r.multinomial(rows2), r.multinomial(rows2, shape=(3,)),
              r.normal(shape=(2,), dtype="float16")):
        rows.append(("shape", api.numpy(d), None, None))
    return rows


def test_random_draws_match_jax_in_shape_dtype_and_moments():
    """Each package's draws: the JAX package's shapes and dtypes, and a
    mean and variance within 5 standard errors of the distribution's."""
    out = {}
    for api in (_Jax, _Port):
        api.mx.random.seed(1)
        with api.cpu():
            out[api] = _draws(api)
    assert [(r[0], r[1].shape, r[1].dtype) for r in out[_Port]] == \
        [(r[0], r[1].shape, r[1].dtype) for r in out[_Jax]]
    for rows in out.values():
        for name, x, mean, var in rows:
            if mean is None:
                continue
            x = x.astype(np.float64)
            se_mean = np.sqrt(var / x.size)
            m4 = np.mean((x - x.mean()) ** 4)
            se_var = np.sqrt(max(m4 - x.var() ** 2, 1e-30) / x.size)
            assert abs(x.mean() - mean) < 5 * se_mean, (name, x.mean(), mean)
            assert abs(x.var() - var) < 5 * se_var, (name, x.var(), var)


@pytest.mark.parametrize("api", [_Jax, _Port], ids=["jax", "port"])
def test_shuffle_permutes_rows_and_randint_stays_in_range(api):
    api.mx.random.seed(2)
    nd = api.mx.nd
    with api.cpu():
        x = api.array(np.arange(200, dtype=np.float32).reshape(100, 2))
        shuffled = api.numpy(nd.random.shuffle(x))
        ints = api.numpy(nd.random.randint(-2, 3, shape=(5000,)))
    assert sorted(map(tuple, shuffled)) == sorted(map(tuple, api.numpy(x)))
    assert not np.array_equal(shuffled, api.numpy(x))
    np.testing.assert_array_equal(shuffled[:, 1] - shuffled[:, 0], 1.0)
    assert ints.dtype == np.int32 and set(np.unique(ints)) == {-2, -1, 0, 1, 2}


def test_port_draws_repeat_under_seed_and_use_their_devices_generator():
    r = mxt.nd.random

    def draw():
        return [mxt.nd.asnumpy(t) for t in (
            r.normal(shape=(64,), ctx=CPU), r.uniform(shape=(8,), ctx=CPU),
            r.gamma(2.0, shape=(8,), ctx=CPU), r.poisson(4.0, shape=(8,),
                                                         ctx=CPU),
            r.randint(0, 100, shape=(8,), ctx=CPU))]
    mxt.random.seed(123)
    first = draw()
    state = torch.get_rng_state()
    second = draw()
    mxt.random.seed(123)
    again = draw()
    for a, b, c in zip(first, again, second):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
    # torch's own default generator is never drawn from
    assert torch.equal(torch.get_rng_state(), state)


def test_random_ops_in_a_symbol_graph():
    """Random and creation ops with no input take the device the graph runs
    on; shape inference on the meta device draws nothing."""
    sym = mxt.sym.broadcast_add(mxt.sym.var("data"),
                                mxt.sym.random_normal(shape=(2, 3)))
    sym = sym + mxt.sym._full(shape=(2, 3), value=1.0)
    _, out_shapes, _ = sym.infer_shape(data=(2, 3))
    assert out_shapes == [(2, 3)]
    mxt.random.seed(4)
    ex = sym.simple_bind(CPU, data=(2, 3))
    ex.forward(data=mxt.nd.zeros((2, 3), ctx=CPU))
    mxt.random.seed(4)
    want = mxt.nd.random.normal(shape=(2, 3), ctx=CPU) + 1.0
    np.testing.assert_array_equal(mxt.nd.asnumpy(ex.outputs[0]),
                                  mxt.nd.asnumpy(want))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_new_entry_points_raise_without_cuda_unless_asked_for_the_cpu(no_cuda):
    nd = mxt.nd
    calls = [lambda **c: nd.ones((2,), **c), lambda **c: nd.full((2,), 1.0, **c),
             lambda **c: nd.arange(3, **c), lambda **c: nd.eye(2, **c),
             lambda **c: nd.random.normal(shape=(2,), **c),
             lambda **c: nd.random.uniform(shape=(2,), **c),
             lambda **c: nd.random.randint(0, 3, shape=(2,), **c)]
    for call in calls:
        with pytest.raises(mxt.MXNetError):
            call()
        assert call(ctx=CPU).device.type == "cpu"


# -- initializers, Constant --------------------------------------------------------
def _init_arrays(api):
    init = api.mx.init
    Desc = api.mx.initializer.InitDesc
    specs = [
        (init.Constant(0.25), "a_weight", (3, 4)),
        (init.Orthogonal(), "b_weight", (4, 6)),
        (init.Orthogonal(scale=0.5, rand_type="normal"), "c_weight", (6, 2, 2)),
        (init.MSRAPrelu(), "d_weight", (5, 3, 2, 2)),
        (init.MSRAPrelu("in", 0.1), "e_weight", (4, 3)),
        (init.Bilinear(), "f_weight", (2, 1, 4, 4)),
        (init.LSTMBias(forget_bias=2.0), "g_bias", (16,)),
        (init.FusedRNN(init.Xavier(), num_hidden=4, num_layers=1,
                       mode="lstm"), "h_parameters", (8, 6)),
        (init.Mixed([".*bias", ".*"], [init.Constant(3.0),
                                       init.Uniform(0.5)]), "i_bias", (3,)),
        (init.Mixed([".*bias", ".*"], [init.Constant(3.0),
                                       init.Uniform(0.5)]), "j_weight", (3, 2)),
        (init.Load({"arg:k_weight": np.arange(6, dtype=np.float32).reshape(
            2, 3)}, default_init=init.Normal(0.1)), "k_weight", (2, 3)),
        (init.Load({}, default_init=init.Normal(0.1)), "l_weight", (2, 3)),
    ]
    out = []
    for ini, name, shape in specs:
        arr = api.mx.nd.zeros(shape, ctx=api.cpu())
        ini(Desc(name), arr)
        out.append(api.numpy(arr))
    out.append(init.FusedRNN(init.Xavier(), 4, 1, "lstm").dumps())
    return out


def test_initializers_bitwise_from_one_seed():
    mxj.random.seed(7)
    want = _init_arrays(_Jax)
    mxt.random.seed(7)
    got = _init_arrays(_Port)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    with pytest.raises(mxt.MXNetError):
        mxt.init.Load({})(mxt.initializer.InitDesc("m_weight"),
                          torch.zeros(2))


def _constants(api):
    params = api.mx.gluon.ParameterDict("net_")
    c = params.get_constant("scale", [[1.0, 2.0], [3.0, 4.0]])
    same = params.get_constant("scale")
    params.initialize(ctx=api.cpu())
    with pytest.raises(KeyError):
        params.get_constant("missing")
    const = api.mx.gluon.Constant("bias", np.array([0.5, -1.0], np.float32))
    const.initialize(ctx=api.cpu())
    return [same is c, c.name, c.grad_req, const.grad_req,
            tuple(c.shape), api.numpy(c.data()), api.numpy(const.data()),
            list(params.keys())]


def test_constant_and_get_constant_match_jax():
    want = _constants(_Jax)
    got = _constants(_Port)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            _close(g, w)
        else:
            assert g == w


# -- MultiHeadAttention --------------------------------------------------------------
def _attention(api, causal, x):
    api.mx.random.seed(0)
    nn = api.mx.gluon.nn
    attn = nn.MultiHeadAttention(64, 4, causal=causal, prefix="attn_")
    attn.initialize(ctx=api.cpu())
    attn.hybridize()
    xs = api.array(x)
    with api.mx.autograd.record():
        out = attn(xs)
        loss = (out * out).sum()
    loss.backward()
    params = attn.collect_params()
    return [api.numpy(out)] + [api.numpy(params[k].grad())
                               for k in sorted(params.keys())]


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax(causal):
    x = np.random.RandomState(3).normal(0, 1, (2, 32, 64)).astype(np.float32)
    want = _attention(_Jax, causal, x)
    got = _attention(_Port, causal, x)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-5)


# -- gluon.utils -----------------------------------------------------------------------
def _utils(api):
    utils = api.mx.gluon.utils
    ctxs = [api.cpu(), api.cpu(), api.cpu()]
    x = np.arange(36, dtype=np.float32).reshape(6, 6)
    parts = utils.split_and_load(x, ctxs)
    parts += utils.split_and_load(api.array(x), ctxs, batch_axis=1)
    parts += utils.split_and_load(api.array(x), ctxs[:1])
    parts += utils.split_data(api.array(x[:5]), 2, even_split=False)
    rs = np.random.RandomState(9)
    arrays = [api.array(rs.normal(0, 1, s).astype(np.float32))
              for s in ((3, 4), (5,), (2, 2, 2))]
    norm = utils.clip_global_norm(arrays, 1.0)
    small = [api.array(np.full((2,), 0.1, np.float32))]
    kept = utils.clip_global_norm(small, 1.0)
    return ([api.numpy(p) for p in parts], norm,
            [api.numpy(a) for a in arrays], kept, api.numpy(small[0]))


def test_split_and_load_and_clip_global_norm_match_jax():
    want = _utils(_Jax)
    got = _utils(_Port)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    assert isinstance(got[1], float)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for g, w in zip(got[2], want[2]):
        _close(g, w)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    _close(got[4], want[4])
    with pytest.raises(ValueError):
        mxt.gluon.utils.split_data(mxt.nd.zeros((5, 2), ctx=CPU), 2)


def test_check_sha1_and_download_of_a_staged_file(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(b"mxnet")
    sha1 = hashlib.sha1(b"mxnet").hexdigest()
    utils = mxt.gluon.utils
    assert utils.check_sha1(str(path), sha1)
    assert not utils.check_sha1(str(path), "0" * 40)
    # a staged file with a matching hash is returned without a fetch
    assert utils.download("http://localhost/blob.bin", path=str(tmp_path),
                          sha1_hash=sha1) == str(path)


# -- gluon.data.vision -----------------------------------------------------------------
def _write_idx(path, arr, gz):
    codes = {np.dtype(np.uint8): 8}
    head = struct.pack(">BBBB", 0, 0, codes[arr.dtype], arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.tobytes())


def _stage(root):
    rs = np.random.RandomState(4)
    mnist = root / "mnist"
    mnist.mkdir()
    for split, n, gz in (("train", 5, False), ("t10k", 3, True)):
        suffix = ".gz" if gz else ""
        _write_idx(str(mnist / f"{split}-images-idx3-ubyte{suffix}"),
                   rs.randint(0, 256, (n, 28, 28)).astype(np.uint8), gz)
        _write_idx(str(mnist / f"{split}-labels-idx1-ubyte{suffix}"),
                   rs.randint(0, 10, (n,)).astype(np.uint8), gz)
    cifar = root / "cifar10" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    for b in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / b, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (2, 3072)).astype(
                np.uint8), b"labels": list(rs.randint(0, 10, 2))}, f)
    c100 = root / "cifar100"
    c100.mkdir()
    for split in ("train", "test"):
        with open(c100 / split, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (3, 3072)).astype(
                np.uint8), b"fine_labels": list(rs.randint(0, 100, 3)),
                b"coarse_labels": list(rs.randint(0, 20, 3))}, f)


def _datasets(api, root):
    v = api.mx.gluon.data.vision
    sets = [v.MNIST(str(root / "mnist")), v.MNIST(str(root / "mnist"),
                                                   train=False),
            v.FashionMNIST(str(root / "mnist")),
            v.CIFAR10(str(root / "cifar10")),
            v.CIFAR10(str(root / "cifar10"), train=False),
            v.CIFAR100(str(root / "cifar100")),
            v.CIFAR100(str(root / "cifar100"), fine_label=False, train=False)]
    out = []
    for ds in sets:
        img, label = ds[1]
        out += [len(ds), api.numpy(img), np.asarray(label)]
    scaled = v.MNIST(str(root / "mnist"), transform=lambda d, l: (d * 2, l))
    out.append(api.numpy(scaled[0][0]))
    return out


def test_vision_datasets_match_jax(tmp_path):
    _stage(tmp_path)
    want = _datasets(_Jax, tmp_path)
    with mxt.cpu():
        got = _datasets(_Port, tmp_path)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            _close(g, w)
        else:
            assert g == w
    with pytest.raises(mxt.MXNetError):
        mxt.gluon.data.vision.MNIST(str(tmp_path / "empty"))
    # ported since: the record and folder datasets (their values are held
    # against the JAX package's in test_torch_recordio.py)
    os.makedirs(tmp_path / "classes" / "a")
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    (tmp_path / "classes" / "a" / "0.png").write_bytes(
        mxt.recordio._imencode(img, img_fmt=".png"))
    rec = mxt.recordio.MXIndexedRecordIO(str(tmp_path / "r.idx"),
                                         str(tmp_path / "r.rec"), "w")
    rec.write_idx(0, mxt.recordio.pack_img((0, 4.0, 0, 0), img,
                                           img_fmt=".npy"))
    rec.close()
    with mxt.cpu():
        folder = mxt.gluon.data.vision.ImageFolderDataset(
            str(tmp_path / "classes"))
        records = mxt.gluon.data.vision.ImageRecordDataset(
            str(tmp_path / "r.rec"))
        items = [folder[0], records[0]]
    assert folder.synsets == ["a"] and len(records) == 1
    for (x, y), label in zip(items, (0, 4.0)):
        assert x.device.type == "cpu" and y == label
        np.testing.assert_array_equal(mxt.nd.asnumpy(x), img)


# -- DCGAN -----------------------------------------------------------------------------
def _dcgan_nets(mx, ngf, ndf):
    """``example/gluon/dcgan.py:26-58``'s generator and discriminator."""
    nn = mx.gluon.nn
    g = nn.HybridSequential(prefix="gen_")
    with g.name_scope():
        for i, (ch, stride, pad) in enumerate(((ngf * 4, 1, 0), (ngf * 2, 2, 1),
                                               (ngf, 2, 1))):
            g.add(nn.Conv2DTranspose(ch, 4, stride, pad, use_bias=False))
            g.add(nn.BatchNorm())
            g.add(nn.Activation("relu"))
        g.add(nn.Conv2DTranspose(3, 4, 2, 1, use_bias=False))
        g.add(nn.Activation("tanh"))
    d = nn.HybridSequential(prefix="disc_")
    with d.name_scope():
        d.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False))
        d.add(nn.LeakyReLU(0.2))
        for ch in (ndf * 2, ndf * 4):
            d.add(nn.Conv2D(ch, 4, 2, 1, use_bias=False))
            d.add(nn.BatchNorm())
            d.add(nn.LeakyReLU(0.2))
        d.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return g, d


def _dcgan_step(api, real, z):
    """One step of ``dcgan.py:94-118``: D on real and fake, then G, each
    with ``loss.backward()`` on the (B,) loss vector.  Returns the two
    losses, each net's gradients from its own backward, and every
    parameter before and after the step."""
    mx = api.mx
    mx.random.seed(0)
    netG, netD = _dcgan_nets(mx, 8, 8)
    for net in (netG, netD):
        net.initialize(mx.init.Normal(0.02), ctx=api.cpu())
        net.hybridize()
    nd = mx.nd
    bs = real.shape[0]
    data, zz = api.array(real), api.array(z)
    netG(zz)
    netD(data)

    def values(net, what):
        return {p.name: api.numpy(getattr(p, what)()).copy()
                for p in net.collect_params().values()
                if what == "data" or p.grad_req != "null"}
    before = {**values(netG, "data"), **values(netD, "data")}
    trainerG = mx.gluon.Trainer(netG.collect_params(), "adam",
                                {"learning_rate": 2e-4, "beta1": 0.5})
    trainerD = mx.gluon.Trainer(netD.collect_params(), "adam",
                                {"learning_rate": 2e-4, "beta1": 0.5})
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    with api.cpu():
        real_label, fake_label = nd.ones((bs,)), nd.zeros((bs,))
    fake = netG(zz)
    with mx.autograd.record():
        errD = loss_fn(netD(data).reshape((-1,)), real_label) + \
            loss_fn(netD(fake.detach()).reshape((-1,)), fake_label)
    errD.backward()
    grads = values(netD, "grad")
    trainerD.step(bs)
    with mx.autograd.record():
        errG = loss_fn(netD(netG(zz)).reshape((-1,)), real_label)
    errG.backward()
    grads.update(values(netG, "grad"))
    trainerG.step(bs)
    after = {**values(netG, "data"), **values(netD, "data")}
    return api.numpy(errD), api.numpy(errG), grads, before, after


def test_dcgan_step_matches_jax():
    """Adam's first step moves a weight by lr * g / (|g| + eps / sqrt(1 -
    beta2)), about lr * sign(g) where |g| is well above 3.2e-7: there the
    weights agree within 1e-4 of the largest change.  A gradient entry
    within 1e-4 of the float32 noise of its tensor (below 1e-4 of the
    tensor's largest entry) is divided by itself, so its move follows the
    noise: those entries are held to the gradient check and to a move of
    at most lr in both packages."""
    rs = np.random.RandomState(0)
    real = np.tanh(rs.normal(0, 1, (4, 3, 32, 32))).astype(np.float32)
    z = rs.normal(0, 1, (4, 100, 1, 1)).astype(np.float32)
    lr = 2e-4
    want = _dcgan_step(_Jax, real, z)
    got = _dcgan_step(_Port, real, z)
    _close(got[0], want[0], 1e-5, 1e-5)
    _close(got[1], want[1], 1e-5, 1e-5)
    assert got[0].shape == (4,)
    assert sorted(got[2]) == sorted(want[2]) and len(want[2]) == 18
    for name, w in want[2].items():
        _close(got[2][name], w, 0, 1e-5 * np.abs(w).max())
    assert sorted(got[4]) == sorted(want[4])
    for name, w in want[4].items():
        np.testing.assert_array_equal(got[3][name], want[3][name])
        moved, moved_port = w - want[3][name], got[4][name] - got[3][name]
        diff = np.abs(moved_port - moved)
        if name in want[2]:
            g = np.abs(want[2][name])
            clear = g > 1e-4 * g.max()
            assert np.abs(moved).max() <= lr * 1.001 and \
                np.abs(moved_port).max() <= lr * 1.001, name
        else:                          # BatchNorm's moving statistics
            clear = np.ones_like(diff, bool)
        assert clear.mean() > 0.99, name
        assert diff[clear].max() <= 1e-4 * np.abs(moved).max(), name
