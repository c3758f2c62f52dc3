"""The port's Symbol graph against the JAX package's, on the CPU.

A small flash TransformerLM (vocab 50, dim 32, 2 layers, 2 heads, max_len
128, float32) is traced to a Symbol in both packages, its JAX parameters
carried into the port by ``convert.params_from_mxnet_tpu``.  Graph JSON
must be byte-identical and load in either package; shape and type
inference must agree, parameters included; the port's ``GraphPlan``, its
hybridized forward (``CachedOp``) and a ``SymbolBlock`` over the loaded
graph must give JAX's hybridized logits within 1e-5 (the JAX package's
flash runs as its own CPU tests run it).  Op values: 1e-6.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import SymbolBlock
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
from mxnet_tpu_torch.symbol.graph import GraphPlan

CPU = mxt.cpu()
KW = dict(vocab=50, dim=32, num_layers=2, num_heads=2, max_len=128,
          attn_type="flash")
TOKENS = np.random.RandomState(0).randint(0, 50, (2, 64)).astype(np.float32)
XAVIER = dict(rnd_type="gaussian", factor_type="in", magnitude=2)


@pytest.fixture(scope="module")
def pair():
    """(JAX net hybridized, port net, their symbols, JAX's logits)."""
    mxj.random.seed(0)
    # fresh name counters: node names must not depend on the tests before
    with mxj.name.NameManager(), mxt.name.NameManager():
        jnet = JaxLM(**KW)
        tnet = TransformerLM(**KW)
    jnet.initialize(mxj.init.Xavier(**XAVIER))
    jnet(mxj.nd.array(TOKENS))          # resolves the deferred shapes
    tnet.initialize(ctx=CPU)
    params_from_mxnet_tpu({n: p.data().asnumpy()
                           for n, p in jnet.collect_params().items()},
                          tnet, prefix=jnet.prefix)
    with mxj.name.NameManager(), mxt.name.NameManager():
        jsym = jnet(mxj.sym.var("data"))
        tsym = tnet(mxt.sym.var("data"))
    jnet.hybridize()
    want = jnet(mxj.nd.array(TOKENS)).asnumpy()
    return jnet, tnet, jsym, tsym, want


def _t(a):
    return mxt.nd.array(a, ctx=CPU)


def _params(net):
    return {p.name: p.data() for p in net.collect_params().values()}


def test_parameter_var_matches_jax():
    """``Parameter.var()`` carries shape, dtype, lr/wd multipliers and the
    initializer as the JAX package writes them, and is made once."""
    with mxj.name.NameManager(), mxt.name.NameManager():
        jnet = JaxLM(**KW)
        tnet = TransformerLM(**KW)
        jd = mxj.gluon.nn.Dense(4, weight_initializer=mxj.init.Xavier(
            magnitude=2))
        td = mxt.gluon.nn.Dense(4, weight_initializer=mxt.init.Xavier(
            magnitude=2))
    jparams = list(jnet.collect_params().values()) + [jd.weight, jd.bias]
    tparams = list(tnet.collect_params().values()) + [td.weight, td.bias]
    for jp, tp in zip(jparams, tparams):
        assert tp.var().list_attr() == jp.var().list_attr()
        assert tp.var() is tp.var()
    assert td.weight.var().attr("__init__") == jd.weight.var().attr(
        "__init__")


def test_graph_json_moves_between_packages(pair):
    jnet, tnet, jsym, tsym, _ = pair
    assert tsym.tojson() == jsym.tojson()
    into_port = mxt.sym.load_json(jsym.tojson())
    into_jax = mxj.sym.load_json(tsym.tojson())
    assert into_port.tojson() == jsym.tojson()
    assert into_jax.tojson() == tsym.tojson()
    nodes = [(n["op"], n["name"], n["attrs"])
             for n in json.loads(tsym.tojson())["nodes"]]
    assert nodes == [(n["op"], n["name"], n["attrs"])
                     for n in json.loads(into_jax.tojson())["nodes"]]
    assert into_port.list_arguments() == jsym.list_arguments()
    assert into_port.list_outputs() == jsym.list_outputs()
    assert into_port.list_auxiliary_states() == []


def test_infer_shape_and_type_match_jax(pair):
    _, _, jsym, tsym, _ = pair
    for shape in ((2, 64), (4, 16)):
        got = tsym.infer_shape(data=shape)
        want = jsym.infer_shape(data=shape)
        assert got == tuple(want)
        assert got[1] == [shape + (50,)]
    # deferred parameter shapes come from the hooks when only data is known
    loaded = mxt.sym.load_json(jsym.tojson())
    assert loaded.infer_shape(data=(2, 64)) == tuple(
        jsym.infer_shape(data=(2, 64)))
    for dt in ("float32", "bfloat16"):
        got = [np.dtype(t) for grp in tsym.infer_type(data=dt) for t in grp]
        want = [np.dtype(t) for grp in jsym.infer_type(data=dt) for t in grp]
        assert got == want
    # a free input no op can size stays unknown, and so does the output
    tpart = loaded * mxt.sym.var("scale")
    jpart = mxj.sym.load_json(jsym.tojson()) * mxj.sym.var("scale")
    got = tpart.infer_shape_partial(data=(2, 64))
    assert got == tuple(jpart.infer_shape_partial(data=(2, 64)))
    assert got[0][-1] is None and got[0][0] == (2, 64)


def test_graph_plan_and_hybridized_forward_match_jax(pair):
    _, tnet, _, tsym, want = pair
    args = _params(tnet)
    args["data"] = _t(TOKENS)
    outs, aux = GraphPlan(tsym).run(args)
    assert aux == {} and len(outs) == 1
    np.testing.assert_allclose(mxt.nd.asnumpy(outs[0]), want,
                               rtol=1e-5, atol=1e-5)
    tnet.hybridize()
    try:
        for _ in range(2):              # the second call reuses the op
            got = mxt.nd.asnumpy(tnet(_t(TOKENS)))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert tnet._cached_op is not None and len(tnet._cached_by_fmt) == 1
    finally:
        tnet.hybridize(False)


def test_symbol_block_over_a_loaded_graph(pair, tmp_path):
    jnet, _, jsym, _, want = pair
    mxj.nd.save(str(tmp_path / "lm.params"), {
        n: p.data() for n, p in jnet.collect_params().items()})
    (tmp_path / "lm.json").write_text(jsym.tojson())
    sym = mxt.sym.load(str(tmp_path / "lm.json"))
    blk = SymbolBlock(sym, mxt.sym.var("data"))
    blk.collect_params().load(str(tmp_path / "lm.params"), ctx=CPU)
    got = mxt.nd.asnumpy(blk(_t(TOKENS)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert sorted(n for n, _ in blk.named_parameters()) == sorted(
        jsym.list_arguments()[1:])
    # composed onto another graph, the block is a Symbol again
    composed = blk(mxt.sym.var("tokens"))
    assert composed.list_arguments()[0] == "tokens"


def test_deferred_init_through_the_graph_matches_jax():
    """A hybridized net resolves its deferred shapes by shape inference
    over the traced graph and draws its parameters in the JAX package's
    order: the same seed gives the same logits."""
    mxj.random.seed(3)
    jnet = JaxLM(**KW)
    jnet.initialize(mxj.init.Xavier(**XAVIER))
    jnet.hybridize()
    want = jnet(mxj.nd.array(TOKENS)).asnumpy()
    mxt.random.seed(3)
    tnet = TransformerLM(**KW)
    tnet.initialize(mxt.init.Xavier(**XAVIER), ctx=CPU)
    tnet.hybridize()
    got = mxt.nd.asnumpy(tnet(_t(TOKENS)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_decode_steps_run_through_the_cached_op(pair):
    """The static-decode and beam wrappers are active blocks: they trace
    once and run their CachedOp, with the eager path's numbers."""
    _, tnet, _, _, _ = pair
    prompt = _t(TOKENS[:, :5])
    greedy = tnet.generate(prompt, 4)
    seq, logp = tnet.beam_search(prompt, 3, beam=2)
    step = tnet._decode_steps()["greedy"]
    beam = tnet._beam_step(2)
    assert step._cached_op is not None and beam._cached_op is not None
    for blk in (step, beam):
        blk._active = False
    try:
        assert torch.equal(tnet.generate(prompt, 4), greedy)
        eager_seq, eager_logp = tnet.beam_search(prompt, 3, beam=2)
        assert torch.equal(eager_seq, seq)
        np.testing.assert_allclose(mxt.nd.asnumpy(eager_logp),
                                   mxt.nd.asnumpy(logp), rtol=1e-6)
    finally:
        for blk in (step, beam):
            blk._active = True


def test_executor_binding_raises_naming_the_roadmap(pair, monkeypatch):
    """``simple_bind``, ``bind`` and ``eval`` of the TransformerLM's symbol
    give JAX's hybridized logits within 1e-5.  A train-mode forward and a
    backward with a head gradient through the executor reach the flash
    backward (``FlashAttentionFn``: K1b's plain version here, once per
    layer) and give the gradients of the same net under
    ``autograd.record()``.  Rematerialised segments (``segments=2``) give
    the same logits and, under ``MXNET_BACKWARD_DO_MIRROR``, the same
    gradients, K1's forward running again inside the backward."""
    _, tnet, _, tsym, want = pair
    params = _params(tnet)
    data = _t(TOKENS)
    ex = tsym.simple_bind(CPU, data=(2, 64))
    ex.copy_params_from(params)
    for out in (ex.forward(data=data)[0],
                tsym.bind(CPU, {**params, "data": data}).forward()[0],
                tsym.eval(CPU, data=data, **params)[0]):
        np.testing.assert_allclose(mxt.nd.asnumpy(out), want, rtol=1e-5,
                                   atol=1e-5)
    import mxnet_tpu_torch.ops.flash_attention as ofa
    calls = []
    bwd = ofa.flash_attention_bwd
    monkeypatch.setattr(ofa, "flash_attention_bwd",
                        lambda *a: calls.append(1) or bwd(*a))
    head = _t(np.random.RandomState(1).normal(size=want.shape)
              .astype(np.float32))
    ex.forward(is_train=True, data=data)
    ex.backward([head])
    assert len(calls) == KW["num_layers"]
    with mxt.autograd.record():
        out = tnet(data)
    mxt.autograd.backward([out], [head])
    for p in tnet.collect_params().values():
        got = mxt.nd.asnumpy(ex.grad_dict[p.name])
        ref = mxt.nd.asnumpy(p.grad())
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), p.name
    seg_out = GraphPlan(tsym).run({"data": data, **params}, segments=2)[0]
    np.testing.assert_allclose(mxt.nd.asnumpy(seg_out[0]), want, rtol=1e-5,
                               atol=1e-5)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    mex = tsym.simple_bind(CPU, data=(2, 64))
    mex.copy_params_from(params)
    calls.clear()
    fwd_calls = []
    fwd = ofa.flash_attention_fwd
    monkeypatch.setattr(ofa, "flash_attention_fwd",
                        lambda *a, **k: fwd_calls.append(1) or fwd(*a, **k))
    mex.forward(is_train=True, data=data)
    mex.backward([head])
    assert len(calls) == KW["num_layers"]
    assert len(fwd_calls) == 2 * KW["num_layers"]     # K1 again inside
    for name, g in mex.grad_dict.items():
        np.testing.assert_array_equal(mxt.nd.asnumpy(g),
                                      mxt.nd.asnumpy(ex.grad_dict[name]))


@pytest.mark.parametrize("k", [2, 3, "sqrt"])
def test_segmented_run_matches_unsegmented_and_jax_bounds(pair, k):
    """``GraphPlan.run(segments=k)``: the JAX package's segment bounds and
    live-in sets, and, in train mode under autograd, the unsegmented run's
    outputs and gradients bitwise."""
    _, tnet, jsym, tsym, _ = pair
    from mxnet_tpu.symbol.graph import GraphPlan as JaxPlan
    plan = GraphPlan(tsym)
    n = len(plan.steps)
    k = max(2, int(n ** 0.5)) if k == "sqrt" else k
    assert plan._segment_layout(k) == JaxPlan(jsym)._segment_layout(k)
    params = _params(tnet)
    res = []
    for segments in (1, k):
        leaves = {n_: v.detach().clone().requires_grad_()
                  for n_, v in params.items()}
        with torch.enable_grad():
            outs, _ = plan.run({"data": _t(TOKENS), **leaves},
                               is_train=True, segments=segments)
            outs[0].square().sum().backward()
        res.append((outs[0].detach(), {n_: v.grad for n_, v in
                                       leaves.items()}))
    torch.testing.assert_close(res[1][0], res[0][0], rtol=0, atol=0)
    for name, g in res[0][1].items():
        torch.testing.assert_close(res[1][1][name], g, rtol=0, atol=0)


@pytest.mark.parametrize("hybridized", [False, True],
                         ids=["eager", "hybridized"])
def test_sequence_longer_than_max_len_raises(hybridized):
    """Past max_len the position embedding would clamp its ids; the net
    refuses such input eagerly and through its CachedOp alike."""
    net = TransformerLM(vocab=50, dim=8, num_layers=1, num_heads=2,
                        max_len=16, attn_type="flash")
    net.initialize(ctx=CPU)
    if hybridized:
        net.hybridize()
    assert net(_t(TOKENS[:, :16])).shape == (2, 16, 50)
    with pytest.raises(ValueError, match="exceeds max_len 16"):
        net(_t(TOKENS[:, :17]))


def test_graph_file_attributes_parse_as_literals_only():
    """Shape hints and op attributes read from a graph file are parsed as
    Python literals: an expression in their place is refused, never run."""
    x = mxt.sym.var("data")
    graph = json.loads(mxt.sym.reshape(x, shape=(3, 4)).tojson())
    graph["nodes"][0]["attrs"]["__shape__"] = "(2, 6)"
    good = mxt.sym.load_json(json.dumps(graph))
    assert good.infer_shape()[1] == [(3, 4)]
    probe = "[c.__name__ for c in ().__class__.__base__.__subclasses__()]"
    for node, attr in ((0, "__shape__"), (1, "shape")):
        bad = json.loads(json.dumps(graph))
        bad["nodes"][node]["attrs"][attr] = probe
        with pytest.raises(ValueError, match="malformed"):
            mxt.sym.load_json(json.dumps(bad)).infer_shape()

_A = np.random.RandomState(5).uniform(0.5, 2.0, (3, 4)).astype(np.float32)
_B = np.random.RandomState(6).uniform(0.5, 2.0, (3, 4)).astype(np.float32)
_B[0, :2] = _A[0, :2]                   # equal entries for `==`

SYMBOL_OPS = [
    ("a + b", lambda F, a, b: a + b), ("a - 2", lambda F, a, b: a - 2.0),
    ("3 - a", lambda F, a, b: 3.0 - a), ("a * b", lambda F, a, b: a * b),
    ("a / 4", lambda F, a, b: a / 4.0), ("2 / a", lambda F, a, b: 2.0 / a),
    ("a ** b", lambda F, a, b: a ** b), ("a ** 2", lambda F, a, b: a ** 2),
    ("-a", lambda F, a, b: -a), ("a == b", lambda F, a, b: a == b),
    ("a == 1", lambda F, a, b: a == 1.0),
    ("pow", lambda F, a, b: F.pow(a, b)),
    ("pow scalar", lambda F, a, b: F.pow(2.0, a)),
    ("maximum", lambda F, a, b: F.maximum(a, b)),
    ("maximum scalar", lambda F, a, b: F.maximum(a, 1.0)),
    ("minimum", lambda F, a, b: F.minimum(1.0, b)),
    ("hypot", lambda F, a, b: F.hypot(a, b)),
    ("hypot scalar", lambda F, a, b: F.hypot(a, 3.0)),
    ("cast", lambda F, a, b: F.Cast(a * b, dtype="float16")),
    ("zeros", lambda F, a, b: a + F.zeros((3, 4))),
    ("ones", lambda F, a, b: a * F.ones((3, 4))),
    ("arange", lambda F, a, b: F.broadcast_add(
        a, F.reshape(F.arange(0, 4, 1.0), (1, 4)))),
    ("arange repeat", lambda F, a, b: F.broadcast_mul(
        a, F.reshape(F.arange(1, 3, repeat=2), (1, 4)))),
]


@pytest.mark.parametrize("name,fn", SYMBOL_OPS,
                         ids=[c[0] for c in SYMBOL_OPS])
def test_symbol_ops_match_jax(name, fn):
    """Symbol arithmetic, the free functions and the creation ops, built
    in both packages, round-tripped through JSON and evaluated."""
    with mxj.name.NameManager(), mxt.name.NameManager():
        jsym = fn(mxj.sym, mxj.sym.var("a"), mxj.sym.var("b"))
        tsym = fn(mxt.sym, mxt.sym.var("a"), mxt.sym.var("b"))
    assert json.loads(tsym.tojson())["nodes"] == json.loads(
        jsym.tojson())["nodes"]
    names = jsym.list_arguments()
    feed = {"a": _A, "b": _B}
    ex = jsym.bind(mxj.cpu(), {n: mxj.nd.array(feed[n]) for n in names})
    want = ex.forward()[0].asnumpy()
    outs, _ = GraphPlan(mxt.sym.load_json(tsym.tojson())).run(
        {n: _t(feed[n]) for n in names})
    got = mxt.nd.asnumpy(outs[0])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
