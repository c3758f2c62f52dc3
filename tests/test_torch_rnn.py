"""The port's recurrent surface against the JAX package's, on the CPU.

The same numpy inputs, made from seeds, go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` (``ctx=cpu()``): the sequence ops (both axes, with and
without lengths), the fused ``RNN`` op in its four modes, one and two
directions, two layers, with non-zero biases (outputs and gradients of
data, parameters and states within 1e-4 of each one's largest), its
symbol's parameter-shape hook, the GRU's bias placement (the JAX
package's, which ``torch.nn.GRU`` does not share), ``_contrib_ctc_loss``
in both blank modes with both length flags and on an impossible alignment
(optax's finite loss, in float64 where float32 rounding at 1e5 hides the
gradient), ``gluon.rnn`` layers and cells (eager and hybridized, both
layouts, ``unroll``, ``_unfuse``, ``BidirectionalCell``), ``mx.rnn`` cells
(``FusedRNNCell.unfuse``, the conv cells, ``encode_sentences``,
``BucketSentenceIter``, the rnn checkpoint), ``BucketingModule.fit`` over
two buckets, ``CellModel``'s greedy tokens through the decode engine and
``gluon.loss.CTCLoss``.  The JAX package's ``RNN`` runs as its own tests
run it, a ``lax.scan``.  The JAX side's compiles are most of this file's
time, so the references share programs: the sequence ops' cases as one
jitted program, the CTC cases one per set of flags, and one jitted ``RNN``
program per configuration for the op cases and the ``gluon.rnn`` layer
cases alike.
"""
import functools
import random

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops import sequence as _jax_seq
from mxnet_tpu.ops.contrib import _ctc_loss as _jax_ctc
from mxnet_tpu.ops.sequence import _rnn as _jax_rnn
from mxnet_tpu.ops.sequence import rnn_param_size as jax_param_size
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.ops.sequence import _unpack_rnn_params, rnn_param_size

CPU = mxt.cpu()
TOL = 1e-4


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if isinstance(x, mxj.nd.NDArray) else \
        mxt.nd.asnumpy(x)


def _close(got, want, tol=TOL):
    """max |got - want| within ``tol`` of max |want| (or of 1 when that
    is 0); NaN and inf where the other has them."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    scale = scale or 1.0
    err = np.abs(got[fin] - want[fin]).max() if fin.any() else 0.0
    assert err <= tol * scale, (err, scale)


class _J:
    mx = mxj

    @staticmethod
    def arr(a):
        return mxj.nd.array(a, dtype=a.dtype)


class _T:
    mx = mxt

    @staticmethod
    def arr(a):
        return mxt.nd.array(a, ctx=CPU, dtype=a.dtype)

    @staticmethod
    def grads(fn, arrays, head_w=None):
        """Outputs of ``fn(*inputs)`` and the gradients of sum(out * w) over
        its outputs (w from a seed) w.r.t. each input."""
        xs = [mxt.nd.attach_grad(_T.arr(a)) for a in arrays]
        with mxt.autograd.record():
            outs = fn(*xs)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            head = sum((o * torch.as_tensor(w)).sum()
                       for o, w in zip(outs, _weights(outs, head_w)))
        head.backward()
        return [_np(o) for o in outs] + [_np(mxt.nd.grad(x)) for x in xs]


def _weights(outs, seed):
    rs = np.random.RandomState(7 if seed is None else seed)
    return [rs.uniform(0.5, 1.5, tuple(o.shape)).astype(
        np.dtype(str(o.dtype).replace("torch.", ""))) for o in outs]


def _jax_grads_all(cases):
    """``_T.grads`` on the JAX side for several (fn, arrays) cases of the
    JAX op functions, jitted as ONE program: the op's own function
    compiled once (its eager ``nd`` call would trace again for the record
    and for the backward), and small programs compile faster together
    than apart."""
    def one(fn, arrays):
        def head(*xs):
            outs = fn(*xs)
            return sum((o * w).sum() for o, w in zip(
                outs, _weights(outs, None))), outs

        (_, outs), grads = jax.value_and_grad(
            head, argnums=tuple(range(len(arrays))), has_aux=True)(*arrays)
        return outs, grads

    res = jax.jit(lambda *groups: [one(fn, g) for (fn, _), g in zip(
        cases, groups)])(*[tuple(a) for _, a in cases])
    return [[np.asarray(v) for v in outs] + [np.asarray(v) for v in grads]
            for outs, grads in res]


# -- the sequence ops --------------------------------------------------------
# SequenceReverse reverses the first axis whatever ``axis`` says in both
# packages, so with lengths and axis=1 the JAX op fails (ROADMAP.md §3);
# SequenceMask without lengths is the identity
_SEQ_CASES = [(op, axis, lengths) for op in ("SequenceLast", "SequenceMask",
                                             "SequenceReverse")
              for axis in (0, 1) for lengths in (False, True)
              if (op, axis, lengths) != ("SequenceReverse", 1, True)
              and (op, lengths) != ("SequenceMask", False)]


_SEQ_LENS = np.array([2, 5, 1], np.float32)


def _seq_case(op, axis, lengths):
    """(data, the op's parameters) of one case."""
    rs = np.random.RandomState(1)
    shape = (5, 3, 2) if axis == 0 else (3, 5, 2)
    p = {"use_sequence_length": lengths, "axis": axis}
    if op == "SequenceMask":
        p["value"] = -1.5
    return rs.normal(size=shape).astype(np.float32), p


@functools.lru_cache(maxsize=None)
def _seq_refs():
    """The JAX op functions' outputs and data gradients for every case."""
    fns = {"SequenceLast": _jax_seq._sequence_last,
           "SequenceMask": _jax_seq._sequence_mask,
           "SequenceReverse": _jax_seq._sequence_reverse}
    cases = []
    for op, axis, lengths in _SEQ_CASES:
        data, p = _seq_case(op, axis, lengths)
        lens = _SEQ_LENS if lengths else None
        cases.append((lambda x, f=fns[op], p=p, lens=lens: [f(p, x, lens)],
                      [data]))
    return dict(zip(_SEQ_CASES, _jax_grads_all(cases)))


@pytest.mark.parametrize("op,axis,lengths", _SEQ_CASES,
                         ids=[f"{o}-axis{a}-{'len' if n else 'nolen'}"
                              for o, a, n in _SEQ_CASES])
def test_sequence_op_matches_jax(op, axis, lengths):
    data, p = _seq_case(op, axis, lengths)
    f = getattr(mxt.nd, op)
    lens = [_T.arr(_SEQ_LENS)] if lengths else []
    got = _T.grads(lambda x: f(x, *lens, **p), [data])
    want = _seq_refs()[(op, axis, lengths)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


# -- the fused RNN op --------------------------------------------------------
_MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")
_RNN_CASES = [(m, bi) for m in _MODES for bi in (False, True)]
# explicit states in the configurations the layer cases run (they share
# these programs), ``use_default_state`` in the others
_EXPLICIT = {("lstm", True), ("gru", False), ("rnn_relu", True),
             ("rnn_tanh", True)}
_RNN_T, _RNN_B, _RNN_I, _RNN_H, _RNN_L = 6, 2, 5, 7, 2


def _rnn_inputs(mode, bi, seed=0):
    rs = np.random.RandomState(seed)
    d = 2 if bi else 1
    n = rnn_param_size(_RNN_L, _RNN_I, _RNN_H, bi, mode)
    st = (_RNN_L * d, _RNN_B, _RNN_H)
    return (rs.normal(size=(_RNN_T, _RNN_B, _RNN_I)).astype(np.float32),
            rs.uniform(-0.4, 0.4, n).astype(np.float32),
            rs.normal(size=st).astype(np.float32) * 0.5,
            rs.normal(size=st).astype(np.float32) * 0.5)


@functools.lru_cache(maxsize=None)
def _jax_rnn_program(mode, bi, n_states, clip=None):
    """The JAX op's 2-layer ``RNN`` of state 7, jitted: (inputs,
    cotangents of its three outputs) -> (outputs, the inputs' gradients).
    One program per configuration, shared by every case that runs it."""
    p = {"p": 0.0, "state_size": _RNN_H, "num_layers": _RNN_L,
         "bidirectional": bi, "mode": mode, "state_outputs": True,
         "use_default_state": n_states == 0,
         "lstm_state_clip_min": clip[0] if clip else None,
         "lstm_state_clip_max": clip[1] if clip else None}

    def run(ins, cts):
        outs, vjp = jax.vjp(
            lambda *xs: _jax_rnn(p, *xs, jax.random.PRNGKey(0)), *ins)
        return outs, vjp(cts)
    return jax.jit(run)


def _rnn_cts(bi, head_w=None):
    """The cotangents of the op's (out, state, cell state): ``_weights``
    of their shapes."""
    d = 2 if bi else 1
    st = np.zeros((_RNN_L * d, _RNN_B, _RNN_H), np.float32)
    return tuple(_weights([np.zeros((_RNN_T, _RNN_B, d * _RNN_H),
                                    np.float32), st, st], head_w))


@pytest.mark.parametrize("mode,bi", _RNN_CASES,
                         ids=[f"{m}-{'bi' if b else 'uni'}"
                              for m, b in _RNN_CASES])
def test_rnn_op_matches_jax(mode, bi):
    """Two layers, T=6, B=2, I=5, H=7, biases uniform(±0.4) inside the
    packed vector, all three outputs (``state_outputs``).  Each mode runs
    once with explicit states and once from ``use_default_state`` (zeros
    made in the op); the one-way LSTM clips its returned cell state
    (``lstm_state_clip_*``)."""
    x, params, h0, c0 = _rnn_inputs(mode, bi)
    assert rnn_param_size(2, 5, 7, bi, mode) == \
        jax_param_size(2, 5, 7, bi, mode)
    explicit = (mode, bi) in _EXPLICIT
    clip = (-0.2, 0.25) if mode == "lstm" and not bi else None
    arrays = [x, params] + ([h0] + ([c0] if mode == "lstm" else [])
                            if explicit else [])
    outs, grads = _jax_rnn_program(mode, bi, len(arrays) - 2, clip)(
        tuple(arrays), _rnn_cts(bi))
    want = [np.asarray(v) for v in tuple(outs) + tuple(grads)]
    kw = {"lstm_state_clip_min": clip[0], "lstm_state_clip_max": clip[1]} \
        if clip else {}
    got = _T.grads(lambda *ins: mxt.nd.RNN(
        *ins, state_size=7, num_layers=2, bidirectional=bi, mode=mode,
        state_outputs=True, use_default_state=not explicit, **kw), arrays)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    if clip:
        assert got[2].min() >= -0.2 and got[2].max() <= 0.25


def test_rnn_symbol_infers_its_parameters_and_outputs():
    """``sym.RNN`` sizes its packed parameters (the JAX package's
    ``rnn_param_size``) and states by the hook, and shows one output, or
    three with ``state_outputs``, with the JAX symbol's names."""
    res = []
    for api in (mxj, mxt):
        ins = [api.sym.var(n) for n in ("data", "p", "h", "c")]
        kw = dict(state_size=7, num_layers=2, bidirectional=True,
                  mode="lstm", name="r")
        one = api.sym.RNN(*ins, **kw)
        three = api.sym.RNN(*ins, state_outputs=True, **kw)
        res.append((one.list_outputs(), three.list_outputs(),
                    one.list_arguments()))
    assert res[1] == res[0] and len(res[1][1]) == 3
    args, outs, _ = three.infer_shape(data=(6, 2, 5))
    assert args == [(6, 2, 5), (jax_param_size(2, 5, 7, True, "lstm"),),
                    (4, 2, 7), (4, 2, 7)]
    assert outs == [(6, 2, 14), (4, 2, 7), (4, 2, 7)]


def test_gru_keeps_the_recurrent_bias_outside_the_reset_gate():
    """The JAX package's fused GRU folds ``bR`` into the hoisted input
    projection: n = tanh(W_n x + bW_n + bR_n + r * (R_n h)).  The port
    keeps that formula; ``torch.nn.GRU`` (cuDNN's formula, bR_n inside the
    reset gate) gives other numbers with a non-zero ``h2h`` bias, so
    routing the op through it would fail here."""
    rs = np.random.RandomState(3)
    T, B, I, H = 5, 2, 3, 4
    x = rs.normal(size=(T, B, I)).astype(np.float32)
    W, R = (rs.uniform(-1, 1, s).astype(np.float32)
            for s in ((3 * H, I), (3 * H, H)))
    bW, bR = (rs.uniform(-1, 1, 3 * H).astype(np.float32) for _ in range(2))
    packed = np.concatenate([W.ravel(), R.ravel(), bW, bR])
    want = mxj.nd.RNN(mxj.nd.array(x), mxj.nd.array(packed), state_size=H,
                      num_layers=1, mode="gru")[0].asnumpy()
    got = _np(mxt.nd.RNN(_T.arr(x), _T.arr(packed), state_size=H,
                         num_layers=1, mode="gru")[0])
    _close(got, want)
    # the formula by hand, bR outside the reset gate
    h = np.zeros((B, H), np.float64)
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    for t in range(T):
        wx = x[t] @ W.T + bW + bR
        rh = h @ R.T
        r = sig(wx[:, :H] + rh[:, :H])
        z = sig(wx[:, H:2 * H] + rh[:, H:2 * H])
        n = np.tanh(wx[:, 2 * H:] + r * rh[:, 2 * H:])
        h = (1 - z) * n + z * h
    _close(got[-1], h)
    gru = torch.nn.GRU(I, H)
    with torch.no_grad():
        for p, v in zip(gru.parameters(), (W, R, bW, bR)):
            p.copy_(torch.as_tensor(v))
        cudnn_formula = gru(torch.as_tensor(x))[0].numpy()
    assert np.abs(cudnn_formula - got).max() > 0.05


# -- CTC -----------------------------------------------------------------------
_CTC_LABELS = {
    "first": np.array([[1, 2, 0, 0], [3, 3, 0, 0], [1, 2, 3, 4],
                       [2, 4, 2, 0]], np.float32),
    "last": np.array([[1, 2, -1, -1], [3, 3, -1, -1], [0, 2, 3, 1],
                      [0, -1, -1, -1]], np.float32),
}
_CTC_CASES = [("first", False, False), ("last", False, True),
              ("first", True, True), ("impossible", False, False),
              ("middle padding", False, False)]


def _ctc_case(blank, data_len, label_len):
    """(activations, labels, lengths, the op's parameters) of one case."""
    rs = np.random.RandomState(5)
    T, N, C = 7, 4, 5
    p = {"use_data_lengths": data_len, "use_label_lengths": label_len,
         "blank_label": "first"}
    if blank == "impossible":
        data = rs.normal(size=(3, 1, 6)).astype(np.float64)
        label = np.array([[1, 2, 3, 4]], np.float64)
    elif blank == "middle padding":
        data = rs.normal(size=(T, N, C)).astype(np.float32)
        label = np.array([[2, 0, 3, 0], [1, 1, 0, 4], [0, 3, 0, 0],
                          [4, 2, 0, 0]], np.float32)
    else:
        data = rs.normal(size=(T, N, C)).astype(np.float32)
        label = _CTC_LABELS[blank]
        p["blank_label"] = blank
    lens = {}
    if data_len:
        # a fraction of a frame counts as a frame, a length past T is T
        lens["data_lengths"] = np.array([7, 4.5, 6, 9], np.float32)
    if label_len:
        lens["label_lengths"] = np.array([2, 2, 4, 1], np.float32)
    return data, label, lens, p


@functools.lru_cache(maxsize=None)
def _jax_ctc_program(use_data_lengths, use_label_lengths, blank_label):
    """The JAX op function (optax), jitted: (activations, labels, lengths,
    the losses' cotangent) -> (losses, the activations' gradient); cases
    with the same flags and shapes share it."""
    p = {"use_data_lengths": use_data_lengths,
         "use_label_lengths": use_label_lengths, "blank_label": blank_label}

    def run(x, label, lens, ct):
        loss, vjp = jax.vjp(lambda v: _jax_ctc(p, v, label, **lens), x)
        return loss, vjp(ct.astype(loss.dtype))[0]
    return jax.jit(run)


@pytest.mark.parametrize("blank,data_len,label_len", _CTC_CASES,
                         ids=["first", "last-label_lengths",
                              "first-both-lengths", "impossible",
                              "middle-padding"])
def test_ctc_loss_matches_jax(blank, data_len, label_len):
    """Losses and gradients w.r.t. the activations, against the JAX op's
    function (optax) jitted.  ``impossible``: 4 labels over 3 frames,
    where optax's recursion gives a finite loss near 1e5 and torch's
    ``ctc_loss`` inf; it runs in float64 (in float32 the rounding at 1e5
    moves the JAX gradient itself by 1e-3).  ``middle padding``: a 0
    between labels, which optax reads as label 0 (the blank) inside the
    target; the JAX result is the target."""
    data, label, lens, p = _ctc_case(blank, data_len, label_len)
    got = _T.grads(lambda x: mxt.nd.contrib.ctc_loss(
        x, _T.arr(label), **{k: _T.arr(v) for k, v in lens.items()}, **p),
        [data])
    loss, grad = _jax_ctc_program(**p)(data, label, lens,
                                       _weights([got[0]], None)[0])
    for g, w in zip(got, (loss, grad)):
        _close(g, w)
    if blank == "impossible":
        assert 1e5 < got[0][0] < 1.0001e5


def test_ctc_symbol_binds_lengths_by_its_flags():
    """With only ``use_label_lengths`` the symbol's third input is the label
    lengths (the positional swap of the JAX op), in both packages."""
    rs = np.random.RandomState(6)
    P = rs.normal(size=(6, 2, 5)).astype(np.float32)
    L = np.array([[1, 2, 3], [2, 4, 0]], np.float32)
    LL = np.array([3, 1], np.float32)
    outs = []
    for api, arr in ((mxj, lambda a: mxj.nd.array(a)), (mxt, _T.arr)):
        s = api.sym.CTCLoss(api.sym.var("pred"), api.sym.var("label"),
                            label_lengths=api.sym.var("ll"),
                            use_label_lengths=True)
        assert s.list_arguments() == ["pred", "label", "ll"]
        ex = s.bind(api.cpu(), {"pred": arr(P), "label": arr(L),
                                "ll": arr(LL)})
        outs.append(_np(ex.forward()[0]))
    _close(outs[1], outs[0])


# -- gluon.rnn -----------------------------------------------------------------
_LAYER_CASES = [("LSTM", False, "TNC", True), ("GRU", True, "NTC", False),
                ("RNN", True, "TNC", True)]


def _layer(api, cls, layout, bi, prefix=None):
    return getattr(api.mx.gluon.rnn, cls)(
        _RNN_H, num_layers=_RNN_L, layout=layout, bidirectional=bi,
        input_size=_RNN_I, h2h_bias_initializer="uniform",
        i2h_bias_initializer="uniform", prefix=prefix)


def _jax_params(block):
    return {n: p.data().asnumpy() for n, p in block.collect_params().items()}


class _JaxLayerRecipe:
    """The namespace for a JAX layer's own ``hybrid_forward`` (its packing
    of the parameters, its layout, its ``RNN`` call) on numpy arrays,
    with each parameter passed as (name, array) so the packed gradient
    can be cut back by name.  The ``RNN`` call runs the shared program
    of ``_jax_rnn_program`` with the cotangents ``cts``."""

    def __init__(self, cts):
        self.cts, self.parts, self.grads = cts, None, None

    @staticmethod
    def Reshape(param, shape):
        return param[0], param[1].reshape(shape)

    def Concat(self, *parts, dim):
        self.parts = [(name, a.size) for name, a in parts]
        return np.concatenate([a for _, a in parts], axis=dim)

    @staticmethod
    def SwapAxis(x, dim1, dim2):
        return np.swapaxes(x, dim1, dim2)

    def RNN(self, *ins, mode, bidirectional, p, **_kw):
        assert p == 0
        outs, self.grads = _jax_rnn_program(
            mode, bidirectional, len(ins) - 2, None)(ins, self.cts)
        return [np.asarray(o) for o in outs]

    def param_grads(self):
        packed, off, out = np.asarray(self.grads[1]), 0, {}
        for name, size in self.parts:
            out[name] = packed[off:off + size]
            off += size
        return out


@pytest.mark.parametrize("cls,hybrid,layout,bi", _LAYER_CASES,
                         ids=[f"{c}-{'hybrid' if h else 'eager'}-{lay}-"
                              f"{'bi' if b else 'uni'}"
                              for c, h, lay, b in _LAYER_CASES])
def test_gluon_rnn_layer_matches_jax(cls, hybrid, layout, bi):
    """Outputs, new states and every parameter's gradient of
    sum(out * w) + sum(state * w), with states passed and (for the output
    alone) without; the JAX layer's weights carried across by name
    (``convert.params_from_mxnet_tpu``).  The JAX side is the layer's own
    ``hybrid_forward``, its ``RNN`` the op cases' program."""
    rs = np.random.RandomState(2)
    x_tnc = rs.normal(size=(_RNN_T, _RNN_B, _RNN_I)).astype(np.float32)
    swap = (lambda a: np.swapaxes(a, 0, 1)) if layout == "NTC" else \
        (lambda a: a)
    d = 2 if bi else 1
    states = [rs.normal(size=(_RNN_L * d, _RNN_B, _RNN_H)).astype(
        np.float32) * 0.5 for _ in range(2 if cls == "LSTM" else 1)]
    mxj.random.seed(0)
    jl = _layer(_J, cls, layout, bi)
    jl.initialize()
    cts = _rnn_cts(bi, head_w=5)
    if cls != "LSTM":       # the layer returns no cell state
        cts = cts[:2] + (np.zeros_like(cts[2]),)
    recipe = _JaxLayerRecipe(cts)
    jp = {n: (n, p.data().asnumpy()) for n, p in jl._reg_params.items()}
    out, new = jl.hybrid_forward(recipe, swap(x_tnc), *states, **jp)
    jgrads = recipe.param_grads()
    tl = _layer(_T, cls, layout, bi, prefix=jl.prefix)
    tl.initialize(ctx=CPU)
    params_from_mxnet_tpu(_jax_params(jl), tl)
    if hybrid:
        tl.hybridize()
    ts = [_T.arr(s).requires_grad_() for s in states]
    with mxt.autograd.record():
        t_out, t_new = tl(_T.arr(swap(x_tnc)), ts)
        head = (t_out * torch.as_tensor(swap(cts[0]))).sum() + sum(
            (s * torch.as_tensor(w)).sum() for s, w in zip(t_new, cts[1:]))
    head.backward()
    _close(_np(t_out), out)
    for g, w in zip(_np(list(t_new)), new):
        _close(g, w)
    for name, prm in tl.collect_params().items():
        short = name[len(jl.prefix):]
        _close(_np(prm.grad()).ravel(), jgrads[short])
    # without states the layer starts from zeros and returns the output
    zeros = [np.zeros_like(st) for st in states]
    out0, _ = jl.hybrid_forward(_JaxLayerRecipe(cts), swap(x_tnc), *zeros,
                                **jp)
    _close(_np(tl(_T.arr(swap(x_tnc)))), out0)


def _word_lm(api, prefix):
    """``example/gluon/word_language_model.py``'s ``RNNModel`` (dropout
    0, so that both packages draw nothing)."""
    gluon = api.mx.gluon

    class RNNModel(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.encoder = gluon.nn.Embedding(20, 6)
                self.rnn = gluon.rnn.LSTM(5, 2, input_size=6)
                self.decoder = gluon.nn.Dense(20, in_units=5)

        def forward(self, inputs, hidden):
            output, hidden = self.rnn(self.encoder(inputs), hidden)
            return self.decoder(output.reshape((-1, 5))), hidden

    return RNNModel(prefix=prefix)


def test_word_language_model_trains_as_in_jax():
    """The example's model, its weights carried across by name, one
    truncated-BPTT step (hybridized LSTM, ``clip_global_norm``, SGD lr
    1): the logits, the carried state and every parameter after the step
    within 1e-4."""
    rs = np.random.RandomState(13)
    x = rs.randint(0, 20, (4, 3)).astype(np.float32)
    y = rs.randint(0, 20, (12,)).astype(np.float32)
    res = []
    for api in (_J, _T):
        api.mx.random.seed(0)
        net = _word_lm(api, "model0_")
        net.initialize(api.mx.init.Xavier(), ctx=api.mx.cpu())
        if api is _T:
            params_from_mxnet_tpu(jparams, net)
        else:
            jparams = _jax_params(net)
        net.rnn.hybridize()
        trainer = api.mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 1.0})
        loss_fn = api.mx.gluon.loss.SoftmaxCrossEntropyLoss()
        hidden = net.rnn.begin_state(batch_size=3, ctx=api.mx.cpu())
        with api.mx.autograd.record():
            out, hidden = net(api.arr(x), hidden)
            loss = loss_fn(out, api.arr(y))
        loss.backward()
        api.mx.gluon.utils.clip_global_norm(
            [p.grad() for p in net.collect_params().values()], 0.25 * 12)
        trainer.step(12)
        res.append([_np(out)] + _np(list(hidden)) +
                   [_np(p.data()) for p in net.collect_params().values()])
    for g, w in zip(res[1], res[0]):
        _close(g, w)


def test_gluon_rnn_layer_unfuses_into_its_cells():
    """``_unfuse`` gives stacked cells over the same parameters; unrolled,
    they give the fused layer's output, which is the JAX layer's.  (One
    direction: ``SequentialRNNCell`` steps each child, and a
    ``BidirectionalCell`` cannot be stepped, in both packages.)"""
    rs = np.random.RandomState(4)
    x = rs.normal(size=(2, 4, 3)).astype(np.float32)
    nets = []
    for api in (_J, _T):
        api.mx.random.seed(0)
        net = api.mx.gluon.rnn.LSTM(5, num_layers=2, layout="NTC",
                                    input_size=3,
                                    h2h_bias_initializer="uniform",
                                    prefix="lstm0_")
        net.initialize(ctx=api.mx.cpu())
        nets.append(net)
    params_from_mxnet_tpu(_jax_params(nets[0]), nets[1])
    want = _np(nets[0](_J.arr(x)))
    fused = _np(nets[1](_T.arr(x)))
    unrolled, _ = nets[1]._unfuse().unroll(4, _T.arr(x), layout="NTC",
                                           merge_outputs=True)
    _close(fused, want)
    _close(_np(unrolled), want)


# RNNCell, GRUCell, the dropout, residual and zoneout cells ride "sequential"
_CELL_CASES = ["sequential", "bidirectional", "valid_length",
               "hybrid-GRUCell"]


def _cell(api, case):
    rnn = api.mx.gluon.rnn
    kw = dict(input_size=3, h2h_bias_initializer="uniform",
              i2h_bias_initializer="uniform")
    if case == "valid_length":
        return rnn.LSTMCell(5, prefix="c_", **kw)
    if case == "hybrid-GRUCell":
        cell = rnn.GRUCell(5, prefix="c_", **kw)
        cell.hybridize()
        return cell
    if case == "sequential":
        cell = rnn.SequentialRNNCell(prefix="s_")
        with cell.name_scope():
            cell.add(rnn.LSTMCell(5, **kw))
            cell.add(rnn.DropoutCell(0.0))
            cell.add(rnn.ResidualCell(rnn.GRUCell(5, input_size=5)))
            cell.add(rnn.ZoneoutCell(rnn.RNNCell(5, input_size=5)))
        return cell
    return rnn.BidirectionalCell(rnn.LSTMCell(5, prefix="l_", **kw),
                                 rnn.GRUCell(5, prefix="r_", **kw))


@pytest.mark.parametrize("case", _CELL_CASES)
def test_gluon_rnn_cell_unroll_matches_jax(case):
    """``unroll`` over 4 steps in NTC (merged outputs) and the final
    states, with ``valid_length`` for one LSTM case; gradients of the
    parameters through the outputs."""
    rs = np.random.RandomState(8)
    x = rs.normal(size=(2, 4, 3)).astype(np.float32)
    vl = np.array([3, 1], np.float32)
    res = []
    for api in (_J, _T):
        api.mx.random.seed(0)
        cell = _cell(api, case)
        cell.initialize(ctx=api.mx.cpu())
        if api is _T:
            params_from_mxnet_tpu(jparams, cell)
        else:
            jparams = _jax_params(cell)
        kw = {"valid_length": api.arr(vl)} if case == "valid_length" else {}
        with api.mx.autograd.record():
            out, states = cell.unroll(4, api.arr(x), layout="NTC",
                                      merge_outputs=True, **kw)
            head = (out * out).sum() + sum(s.sum() for s in states)
        head.backward()
        res.append([_np(out)] + _np(list(states)) +
                   [_np(p.grad()) for p in cell.collect_params().values()])
    assert len(res[0]) == len(res[1])
    for g, w in zip(res[1], res[0]):
        _close(g, w)


# -- mx.rnn --------------------------------------------------------------------
def _bind_run(api, sym, args):
    """Forward of ``sym`` bound on the CPU with numpy ``args``."""
    arr = _T.arr if api is mxt else (lambda a: mxj.nd.array(a))
    ex = sym.bind(api.cpu(), {k: arr(v) for k, v in args.items()})
    return [_np(o) for o in ex.forward()]


def _fused_lstm_args(packed, L, I, H, prefix):
    """The per-cell weights of ``FusedRNNCell.unfuse()``'s stack, cut
    from the fused vector."""
    ws, rs, bws, brs = _unpack_rnn_params(torch.as_tensor(packed), L, I, H,
                                          False, "lstm")
    out = {}
    for i in range(L):
        for name, v in (("i2h_weight", ws[i][0]), ("h2h_weight", rs[i][0]),
                        ("i2h_bias", bws[i][0]), ("h2h_bias", brs[i][0])):
            out[f"{prefix}l{i}_{name}"] = v.numpy().copy()
    return out


def test_fused_rnn_cell_matches_jax_and_its_unfused_stack():
    """A 2-layer ``FusedRNNCell`` LSTM unrolled over 5 steps (NTC, its
    begin states ``zeros`` of batch 0 filled in at bind) against the JAX
    package's, and against its ``unfuse()`` stack of ``LSTMCell``s on the
    same weights (an LSTM: the fused GRU is not its cells' GRU)."""
    rs = np.random.RandomState(9)
    N, T, I, H, L = 2, 5, 3, 4, 2
    x = rs.normal(size=(N, T, I)).astype(np.float32)
    packed = rs.uniform(-0.5, 0.5, rnn_param_size(L, I, H, False, "lstm")
                        ).astype(np.float32)
    outs = []
    for api in (mxj, mxt):
        cell = api.rnn.FusedRNNCell(H, num_layers=L, mode="lstm",
                                    prefix="f_")
        out, _ = cell.unroll(T, api.sym.var("data"), layout="NTC",
                             merge_outputs=True)
        outs.append(_bind_run(api, out, {"data": x,
                                         "f_parameters": packed})[0])
        stack = cell.unfuse()
        assert not cell.steppable and stack.steppable
    _close(outs[1], outs[0])
    u_out, _ = stack.unroll(T, mxt.sym.var("data"), layout="NTC",
                            merge_outputs=True)
    args = _fused_lstm_args(packed, L, I, H, "f_")
    args["data"] = x
    _close(_bind_run(mxt, u_out, args)[0], outs[0], tol=1e-5)


_CONV_CELLS = ["ConvRNNCell", "ConvLSTMCell", "ConvGRUCell"]


@pytest.mark.parametrize("name", _CONV_CELLS)
def test_conv_rnn_cell_matches_jax(name):
    """Three steps of a conv cell over (N, C, H, W) maps, merged NTC."""
    rs = np.random.RandomState(10)
    x = rs.normal(size=(2, 3, 2, 5, 5)).astype(np.float32)
    outs = []
    for api in (mxj, mxt):
        cell = getattr(api.rnn, name)(input_shape=(2, 5, 5), num_hidden=3,
                                      prefix="c_")
        out, states = cell.unroll(3, api.sym.var("data"), layout="NTC",
                                  merge_outputs=True)
        sym = api.sym.Group([out] + list(states))
        if api is mxj:
            shapes = dict(zip(sym.list_arguments(),
                              sym.infer_shape(data=x.shape)[0]))
            args = {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
                    for n, s in shapes.items() if n != "data"}
            args["data"] = x
        outs.append(_bind_run(api, sym, args))
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)


def test_encode_sentences_and_bucket_iter_match_jax():
    """``encode_sentences`` (a new vocabulary, then a given one with an
    unknown token) and every batch of ``BucketSentenceIter`` under the
    same Python and numpy seeds: data, label, bucket key and shapes."""
    sents = [["a", "b", "c"], ["b", "d"], ["a", "a", "e", "f", "b"],
             ["c"], ["d", "e", "f", "a", "b", "c"], ["f", "f"]]
    res = []
    for api in (mxj, mxt):
        coded, vocab = api.rnn.encode_sentences(sents, invalid_label=0,
                                                start_label=1)
        again = api.rnn.encode_sentences([["a", "zz"]], vocab=dict(vocab),
                                         unknown_token="<unk>")
        random.seed(0)
        np.random.seed(0)
        it = api.rnn.BucketSentenceIter(coded * 3, 2, buckets=[3, 6],
                                        invalid_label=0)
        batches = [(_np(b.data[0]), _np(b.label[0]), b.bucket_key,
                    b.provide_data[0].shape) for b in it]
        res.append((coded, vocab, again, it.default_bucket_key, batches))
    got, want = res[1], res[0]
    assert got[:4] == want[:4]
    assert len(got[4]) == len(want[4])
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]


def test_rnn_checkpoint_round_trip(tmp_path):
    """``save_rnn_checkpoint`` writes per-gate weights the JAX package's
    ``load_rnn_checkpoint`` packs back, and the port's too."""
    rs = np.random.RandomState(11)
    cell = mxt.rnn.LSTMCell(4, prefix="l_")
    out, _ = cell.unroll(2, [mxt.sym.var("a"), mxt.sym.var("b")],
                         merge_outputs=True)
    arg = {"l_i2h_weight": rs.normal(size=(16, 3)),
           "l_i2h_bias": rs.normal(size=(16,)),
           "l_h2h_weight": rs.normal(size=(16, 4)),
           "l_h2h_bias": rs.normal(size=(16,))}
    arg = {k: _T.arr(v.astype(np.float32)) for k, v in arg.items()}
    prefix = str(tmp_path / "rnn")
    mxt.rnn.do_rnn_checkpoint(cell, prefix)(0, out, dict(arg), {})
    _, saved, _ = mxt.model.load_checkpoint(prefix, 1)
    assert "l_i2h_i_weight" in saved and "l_i2h_weight" not in saved
    _, port_arg, _ = mxt.rnn.load_rnn_checkpoint(cell, prefix, 1)
    _, jax_arg, _ = mxj.rnn.load_rnn_checkpoint(
        mxj.rnn.LSTMCell(4, prefix="l_"), prefix, 1)
    for k, v in arg.items():
        np.testing.assert_array_equal(_np(port_arg[k]), _np(v))
        np.testing.assert_array_equal(_np(jax_arg[k]), _np(v))


# -- BucketingModule ---------------------------------------------------------
def _bucket_sym_gen(api, vocab=12, embed=6, hidden=8):
    stack = api.rnn.SequentialRNNCell()
    stack.add(api.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_l0_"))

    def sym_gen(seq_len):
        data = api.sym.Variable("data")
        label = api.sym.Variable("softmax_label")
        emb = api.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                                name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=emb, merge_outputs=True)
        pred = api.sym.Reshape(outputs, shape=(-1, hidden))
        pred = api.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = api.sym.Reshape(label, shape=(-1,))
        pred = api.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def test_bucketing_module_fit_matches_jax():
    """``example/rnn/lstm_bucketing.py`` in small: an embedding, one LSTM
    cell of 8 and a softmax over 12 ids, SGD, two batches over buckets 3
    and 6, from the JAX module's initial weights; the parameters after
    ``fit`` within 1e-4, both buckets bound, the metric equal."""
    sents = [[1, 2, 3], [4, 5], [2, 6, 7, 8, 9], [3, 3, 10, 11, 2, 1]]
    res = []
    for api in (mxj, mxt):
        random.seed(0)
        np.random.seed(0)
        it = api.rnn.BucketSentenceIter(sents, 2, buckets=[3, 6],
                                        invalid_label=0)
        kw = {"context": mxt.cpu()} if api is mxt else {}
        mod = api.mod.BucketingModule(_bucket_sym_gen(api),
                                      default_bucket_key=6, **kw)
        mod.bind(it.provide_data, it.provide_label)
        if api is mxj:
            mod.init_params(mxj.init.Xavier())
            start, _ = mod.get_params()
            start = {k: v.asnumpy() for k, v in start.items()}
        else:
            mod.init_params(arg_params={k: _T.arr(v)
                                        for k, v in start.items()})
        metric = api.metric.Perplexity(ignore_label=0)
        mod.fit(it, eval_metric=metric, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5}, num_epoch=1)
        arg, _ = mod.get_params()
        res.append(({k: _np(v) for k, v in arg.items()},
                    sorted(mod._buckets), metric.get()[1]))
    assert res[1][1] == res[0][1] == [3, 6]
    assert set(res[1][0]) == set(res[0][0])
    for k, w in res[0][0].items():
        _close(res[1][0][k], w)
        assert np.abs(w - start[k]).max() > 0      # it trained
    assert abs(res[1][2] - res[0][2]) <= TOL * res[0][2]


def test_bucketing_module_generates_through_a_cell_model():
    """``generate`` without an engine raises the typed route error; with
    ``CellModel`` over a 2-layer ``LSTMCell`` stack it gives the JAX
    engine's greedy tokens, solo and two at once."""
    from mxnet_tpu.serving import decode as jdecode
    from mxnet_tpu_torch.serving import decode
    prompts, new = [[1, 2, 3], [5], [7, 7]], [6, 4, 5]
    toks = []
    for api, dec in ((mxj, jdecode), (mxt, decode)):
        stack = api.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(api.rnn.LSTMCell(num_hidden=8, prefix=f"lstm_l{i}_"))
        model = dec.CellModel(stack, vocab=16, seed=0)
        params = model.init_params() if api is mxj else jparams
        jparams = params
        mod = api.mod.BucketingModule(_bucket_sym_gen(api),
                                      default_bucket_key=4)
        with pytest.raises(dec.GenerativeRouteError):
            mod.generate([1], 2)
        kw = {"dev": mxt.cpu()} if api is mxt else {}
        eng = dec.DecodeEngine(model, params=params, slots=2, page_tokens=4,
                               max_pages=4, warmup=False, **kw)
        mod.attach_decode_engine(eng)
        solo = [mod.generate(p, n) for p, n in zip(prompts, new)]
        futs = [eng.submit(p, n) for p, n in zip(prompts[:2], new[:2])]
        eng.drain()
        toks.append((solo, [f.result(timeout=10) for f in futs]))
        eng.close()
        with pytest.raises(dec.GenerativeRouteError):
            dec.CellModel(api.rnn.FusedRNNCell(8, prefix="f_"), vocab=16)
    assert toks[1] == toks[0]
    assert toks[1][1] == toks[1][0][:2]


def test_gluon_ctc_loss_matches_jax():
    """``gluon.loss.CTCLoss`` (NTC activations, blank last, labels padded
    with -1, activation lengths), eager and hybridized, against the JAX
    loss hybridized."""
    rs = np.random.RandomState(12)
    pred = rs.normal(size=(3, 6, 5)).astype(np.float32)
    label = np.array([[0, 1, -1], [2, 2, 3], [1, -1, -1]], np.float32)
    plen = np.array([6, 5, 4], np.float32)
    jl = mxj.gluon.loss.CTCLoss()
    jl.hybridize()
    want = jl(mxj.nd.array(pred), mxj.nd.array(label),
              mxj.nd.array(plen)).asnumpy()
    for hybrid in (False, True):
        tl = mxt.gluon.loss.CTCLoss()
        if hybrid:
            tl.hybridize()
        _close(_np(tl(_T.arr(pred), _T.arr(label), _T.arr(plen))), want)
