"""The port's KV-cache decode path against the JAX package's, on the CPU.

``mha_decode_step``, the ops beam search needs (ordering, softmax,
``repeat``/``tile``, the unary table), ``generate(kv_cache=True)``,
``beam_search`` and the ``.params`` files, each fed the same numpy-seeded
inputs in both packages.  Tolerances: the decode step 1e-4 relative /
1e-5 absolute (the JAX package's pin for it); op values 1e-6 (float32 math
in another library); indices, tokens and beams exact; beam log-probs 1e-4.
The small net is the one of ``test_torch_transformer.py``, its parameters
carried from the JAX net by ``convert.params_from_mxnet_tpu``.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM

CPU = mxt.cpu()
KW = dict(vocab=32, dim=32, num_layers=2, num_heads=4, max_len=16,
          attn_type="flash")
PROMPT = np.random.RandomState(1).randint(0, 32, (2, 5)).astype(np.float32)


def _jax_net(seed=0):
    mxj.random.seed(seed)
    jnet = JaxLM(**KW)
    jnet.initialize(mxj.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    jnet(mxj.nd.array(PROMPT))          # resolves the deferred shapes
    return jnet


def _port_net():
    tnet = TransformerLM(**KW)
    tnet.initialize(ctx=CPU)
    return tnet


@pytest.fixture(scope="module")
def pair():
    jnet = _jax_net()
    tnet = _port_net()
    params_from_mxnet_tpu({n: p.data().asnumpy()
                           for n, p in jnet.collect_params().items()},
                          tnet, prefix=jnet.prefix)
    return jnet, tnet


def _t(a):
    return mxt.nd.array(a, ctx=CPU)


def _np(x):
    return mxt.nd.asnumpy(x)


# ---------------------------------------------------------------------------
# mha_decode_step
# ---------------------------------------------------------------------------
def test_mha_decode_step_matches_jax():
    """Token by token through both ops from zero caches: outputs and
    caches agree, and the port's input caches are never written."""
    rs = np.random.RandomState(3)
    B, H, T, D = 2, 4, 10, 32
    dh = D // H
    qkv = rs.normal(0, 1, (B, T, 3 * D)).astype(np.float32)
    jk = jv = mxj.nd.zeros((B, H, T, dh))
    tk = tv = _t(np.zeros((B, H, T, dh), np.float32))
    for t in range(T):
        step = qkv[:, t:t + 1]
        jo, jk, jv = mxj.nd.mha_decode_step(
            mxj.nd.array(step), jk, jv, mxj.nd.array([float(t)]),
            num_heads=H)
        k_before, v_before = tk.clone(), tv.clone()
        to, nk, nv = mxt.nd.mha_decode_step(_t(step), tk, tv,
                                            _t([float(t)]), num_heads=H)
        assert torch.equal(tk, k_before) and torch.equal(tv, v_before)
        tk, tv = nk, nv
        for got, want in ((to, jo), (tk, jk), (tv, jv)):
            np.testing.assert_allclose(_np(got), want.asnumpy(),
                                       rtol=1e-4, atol=1e-5)


def test_mha_decode_step_mask_excludes_future():
    """Garbage beyond position t in the cache must not reach the output,
    in either package."""
    rs = np.random.RandomState(4)
    B, H, T, D = 1, 2, 8, 16
    dh = D // H
    qkv = rs.normal(0, 1, (B, 1, 3 * D)).astype(np.float32)
    clean = np.zeros((B, H, T, dh), np.float32)
    dirty_k = rs.normal(0, 1, (B, H, T, dh)).astype(np.float32)
    dirty_v = rs.normal(0, 1, (B, H, T, dh)).astype(np.float32)
    want = mxj.nd.mha_decode_step(
        mxj.nd.array(qkv), mxj.nd.array(dirty_k), mxj.nd.array(dirty_v),
        mxj.nd.array([0.0]), num_heads=H)[0].asnumpy()
    o_clean = mxt.nd.mha_decode_step(_t(qkv), _t(clean), _t(clean),
                                     _t([0.0]), num_heads=H)[0]
    o_dirty = mxt.nd.mha_decode_step(_t(qkv), _t(dirty_k), _t(dirty_v),
                                     _t([0.0]), num_heads=H)[0]
    np.testing.assert_allclose(_np(o_dirty), _np(o_clean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(o_dirty), want, rtol=1e-4, atol=1e-5)


def test_mha_decode_step_bf16_caches_keep_their_dtype():
    qkv = _t(np.ones((1, 1, 24), np.float32)).to(torch.bfloat16)
    kc = torch.zeros(1, 2, 4, 4, dtype=torch.bfloat16)
    out, nk, nv = mxt.nd.mha_decode_step(qkv, kc, kc, _t([1.0]), num_heads=2)
    assert out.dtype == nk.dtype == nv.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mxt.nd.mha_decode_step(qkv, kc, kc, _t([1.0]), num_heads=2,
                               impl="ring")


# ---------------------------------------------------------------------------
# The ops beam search and sampling need, one parametrised test per family
# ---------------------------------------------------------------------------
def _both(op, x, exact=False, **kw):
    want = getattr(mxj.nd, op)(mxj.nd.array(x), **kw).asnumpy()
    got = _np(getattr(mxt.nd, op)(_t(x), **kw))
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


_rs = np.random.RandomState(0)
# ties: a row of repeated values, and equal maxima in different columns
_TIES = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0],
                  [0.5, 0.5, 0.5, 0.5, -1.0, 0.5]], np.float32)
_X = _rs.normal(0, 1, (3, 4, 5)).astype(np.float32)

ORDERING = [
    ("topk", _TIES, dict(k=3), True),
    ("topk", _TIES, dict(k=4, is_ascend=True), True),
    ("topk", _TIES, dict(k=2, ret_typ="value"), True),
    ("topk", _X, dict(k=2, axis=1), True),
    ("topk", _X, dict(k=3, axis=0, ret_typ="value"), True),
    ("argsort", _TIES, dict(), True),
    ("argsort", _TIES, dict(is_ascend=False), True),
    ("argsort", _X, dict(axis=1, is_ascend=False), True),
    ("sort", _TIES, dict(), True),
    ("sort", _X, dict(axis=0, is_ascend=False), True),
]


@pytest.mark.parametrize("op,x,kw,exact", ORDERING,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ORDERING)])
def test_ordering_ops_match_jax(op, x, kw, exact):
    _both(op, x, exact, **kw)


def test_topk_refuses_unported_ret_typ():
    with pytest.raises(MXNetError, match="ret_typ"):
        mxt.nd.topk(_t(_TIES), k=2, ret_typ="both")


SOFTMAX = [("softmax", {}), ("softmax", {"axis": 0}),
           ("softmax", {"temperature": 0.5}), ("log_softmax", {}),
           ("log_softmax", {"axis": 1, "temperature": 2.0})]


@pytest.mark.parametrize("op,kw", SOFTMAX,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SOFTMAX)])
def test_softmax_ops_match_jax(op, kw):
    _both(op, _X * 3.0, **kw)


SHAPE = [("repeat", dict(repeats=3, axis=0)), ("repeat", dict(repeats=2)),
         ("repeat", dict(repeats=2, axis=-1)), ("tile", dict(reps=(2, 1, 3))),
         ("tile", dict(reps=(2,))), ("tile", dict(reps=(2, 1, 1, 2)))]


@pytest.mark.parametrize("op,kw", SHAPE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SHAPE)])
def test_repeat_tile_match_jax(op, kw):
    _both(op, _X, exact=True, **kw)


_ANY = np.concatenate([_rs.uniform(-3, 3, 40),
                       [0.5, 1.5, 2.5, -0.5, -2.5, 0.0, -1.0]]
                      ).astype(np.float32)
_POS = _rs.uniform(0.1, 3.0, 40).astype(np.float32)
_UNIT = _rs.uniform(-0.95, 0.95, 40).astype(np.float32)
_DOMAIN = {"sqrt": _POS, "rsqrt": _POS, "log": _POS, "log10": _POS,
           "log2": _POS, "log1p": _POS, "gamma": _POS, "gammaln": _POS,
           "arcsin": _UNIT, "arccos": _UNIT, "arctanh": _UNIT,
           "erfinv": _UNIT, "arccosh": 1.0 + _POS, "reciprocal": _POS,
           "rcbrt": _POS}
UNARY = sorted(mxt.ops.elemwise._UNARY) + ["softrelu"]


# XLA's float32 lgamma is up to 2e-6 off the exact value on (0.1, 3), where
# torch's is within 1.2e-7: these two are held to float64 math instead
_EXACT = {"gammaln": math.lgamma, "gamma": math.gamma}


@pytest.mark.parametrize("op", UNARY)
def test_unary_ops_match_jax(op):
    assert set(mxt.ops.elemwise._UNARY) == set(mxj.ops.elemwise._UNARY)
    x = _DOMAIN.get(op, _ANY)
    if op not in _EXACT:
        _both(op, x)
        return
    got = _np(getattr(mxt.nd, op)(_t(x)))
    want = np.array([_EXACT[op](float(v)) for v in x])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The KV decode path and beam search
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.9, 5)])
def test_kv_generate_matches_jax_and_static(pair, temperature, top_k):
    jnet, tnet = pair
    want = jnet.generate(mxj.nd.array(PROMPT), 6, temperature=temperature,
                         rng=np.random.RandomState(7), top_k=top_k,
                         kv_cache=True).asnumpy()
    got = _np(tnet.generate(_t(PROMPT), 6, temperature=temperature,
                            rng=np.random.RandomState(7), top_k=top_k,
                            kv_cache=True))
    static = _np(tnet.generate(_t(PROMPT), 6, temperature=temperature,
                               rng=np.random.RandomState(7), top_k=top_k))
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, static)


def test_eager_generate_matches_static(pair):
    _, tnet = pair
    np.testing.assert_array_equal(
        _np(tnet.generate(_t(PROMPT), 4, static_shapes=False)),
        _np(tnet.generate(_t(PROMPT), 4)))


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_search_matches_jax(pair, beam):
    jnet, tnet = pair
    jseq, jlp = jnet.beam_search(mxj.nd.array(PROMPT), 6, beam=beam)
    seq, lp = tnet.beam_search(_t(PROMPT), 6, beam=beam)
    np.testing.assert_array_equal(_np(seq), jseq.asnumpy())
    np.testing.assert_allclose(_np(lp), jlp.asnumpy(), rtol=1e-4, atol=1e-4)
    if beam == 1:
        np.testing.assert_array_equal(
            _np(seq), _np(tnet.generate(_t(PROMPT), 6, kv_cache=True)))


def test_decode_flags_are_checked(pair):
    _, tnet = pair
    for static in (True, False):
        with pytest.raises(ValueError, match="kv_cache"):
            tnet.generate(_t(PROMPT), 2, kv_cache=True, static_shapes=static)
    with pytest.raises(ValueError):
        tnet.beam_search(_t(PROMPT), 2, beam=0)
    with pytest.raises(ValueError, match="max_len"):
        tnet.generate(_t(PROMPT), 12, kv_cache=True)


# ---------------------------------------------------------------------------
# .params files, both directions between the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_params_across_packages(pair, tmp_path, direction):
    """A net that loads the other package's file decodes the same tokens
    with the KV cache (the pattern of the JAX package's save/load test)."""
    jnet, tnet = pair
    path = str(tmp_path / "lm.params")
    want = jnet.generate(mxj.nd.array(PROMPT), 6, kv_cache=True).asnumpy()
    if direction == "jax_to_port":
        jnet.save_params(path)
        fresh = TransformerLM(**KW)         # never initialized
        fresh.load_params(path, ctx=CPU)
        got = _np(fresh.generate(_t(PROMPT), 6, kv_cache=True))
    else:
        tnet.save_params(path)
        fresh = _jax_net(seed=9)            # another init
        fresh.load_params(path)
        got = fresh.generate(mxj.nd.array(PROMPT), 6,
                             kv_cache=True).asnumpy()
    np.testing.assert_array_equal(got, want)


def test_load_params_checks_names(pair, tmp_path):
    _, tnet = pair
    path = str(tmp_path / "lm.params")
    tnet.save_params(path)
    small = TransformerLM(**dict(KW, num_layers=1))
    with pytest.raises(MXNetError, match="not present"):
        small.load_params(path, ctx=CPU)
    small.load_params(path, ctx=CPU, ignore_extra=True)
    big = TransformerLM(**dict(KW, num_layers=3))
    with pytest.raises(MXNetError, match="missing"):
        big.load_params(path, ctx=CPU)


@pytest.mark.parametrize("kind", ["single", "list", "dict"])
def test_nd_save_load_round_trip(tmp_path, kind):
    """float32 and bfloat16 through the file; the JAX package reads the
    port's float32 files."""
    a = _rs.normal(0, 1, (3, 4)).astype(np.float32)
    b = _rs.normal(0, 1, (5,)).astype(np.float32)
    ta, tb = _t(a), _t(b).to(torch.bfloat16)
    data = {"single": ta, "list": [ta, tb], "dict": {"a": ta, "b": tb}}[kind]
    path = str(tmp_path / "x.nd")
    mxt.nd.save(path, data)
    with CPU:
        back = mxt.nd.load(path)
        with open(path, "rb") as f:
            back_buf = mxt.nd.load_frombuffer(f.read())
    for loaded in (back, back_buf):
        flat = {"single": lambda d: [d], "list": list,
                "dict": lambda d: [d["a"], d["b"]]}[kind]
        for got, want in zip(flat(loaded), flat(data)):
            assert got.dtype == want.dtype and torch.equal(got, want)
    if kind == "single":
        np.testing.assert_array_equal(mxj.nd.load(path).asnumpy(), a)


def test_reference_format_raises(tmp_path):
    path = tmp_path / "ref.params"
    path.write_bytes(np.array([0x112, 0], "<u8").tobytes())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mxt.nd.load(str(path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mxt.nd.load_frombuffer(path.read_bytes())


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_kv_path_raises_without_cuda(pair, no_cuda, tmp_path):
    """Without an explicit cpu() the caches and loaded tensors go to
    gpu(0), which raises here: no fallback."""
    _, tnet = pair
    with pytest.raises(MXNetError):
        tnet._init_caches(1)
    path = str(tmp_path / "lm.params")
    tnet.save_params(path)
    with pytest.raises(MXNetError):
        mxt.nd.load(path)
    with pytest.raises(MXNetError):
        TransformerLM(**KW).load_params(path)
