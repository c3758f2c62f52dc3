"""The port's flash-attention TransformerLM against the JAX package's.

Both nets are built at a small width; the JAX net's parameters are carried
into the port by ``convert.params_from_mxnet_tpu``.  Logits agree within
1e-4 relative / 1e-5 absolute (the JAX package's logit pin; float32 in
both, summed in another order); greedy tokens must be equal.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM

CPU = mxt.cpu()


def _pair(max_len=16, tokens=None):
    kw = dict(vocab=32, dim=32, num_layers=2, num_heads=4, max_len=max_len,
              attn_type="flash")
    mxj.random.seed(0)
    jnet = JaxLM(**kw)
    jnet.initialize(mxj.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    jnet(mxj.nd.array(tokens))          # resolves the deferred shapes
    np_params = {n: p.data().asnumpy()
                 for n, p in jnet.collect_params().items()}
    tnet = TransformerLM(**kw)
    tnet.initialize(ctx=CPU)
    params_from_mxnet_tpu(np_params, tnet, prefix=jnet.prefix)
    return jnet, tnet


@pytest.mark.parametrize("max_len,shape", [(16, (2, 16)), (256, (1, 256))])
def test_logits_match_jax(max_len, shape):
    """max_len 256: the flash grid has two 128-blocks along q and k."""
    tokens = np.random.RandomState(42).randint(0, 32, shape).astype(np.float32)
    jnet, tnet = _pair(max_len, tokens)
    want = jnet(mxj.nd.array(tokens)).asnumpy()
    got = mxt.nd.asnumpy(tnet(mxt.nd.array(tokens, ctx=CPU)))
    assert got.shape == shape + (32,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_greedy_generate_matches_jax():
    prompt = np.random.RandomState(1).randint(0, 32, (2, 5)).astype(np.float32)
    jnet, tnet = _pair(16, prompt)
    want = jnet.generate(mxj.nd.array(prompt), 6).asnumpy()
    got = mxt.nd.asnumpy(tnet.generate(mxt.nd.array(prompt, ctx=CPU), 6))
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.0, 0, 0.0), (0.8, 0, 0.0), (1.0, 10, 0.0),
                          (0.7, 0, 0.9), (1.2, 20, 0.8)])
def test_sample_matches_jax(temperature, top_k, top_p):
    logits = np.random.RandomState(3).normal(0, 2, (4, 50)).astype(np.float32)
    want = JaxLM._sample(mxj.nd.array(logits), temperature,
                         np.random.RandomState(7), top_k, top_p)
    got = TransformerLM._sample(mxt.nd.array(logits, ctx=CPU), temperature,
                                np.random.RandomState(7), top_k, top_p)
    np.testing.assert_array_equal(got, want)


def test_unported_paths_raise(tmp_path):
    """The sequence-parallel attention types raise, naming the ROADMAP;
    ``export_decode_step`` (ported since) writes its two files."""
    tnet = TransformerLM(vocab=8, dim=16, num_layers=1, num_heads=2,
                         max_len=8, attn_type="flash")
    tnet.initialize(ctx=CPU)
    tnet(mxt.nd.array(np.zeros((1, 4), np.float32), ctx=CPU))
    names = tnet.export_decode_step(str(tmp_path / "x"))
    assert names == ["data0", "data1", "data2", "data3"]
    assert sorted(os.listdir(tmp_path)) == ["x-0000.params",
                                            "x-symbol.json"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerLM(vocab=8, dim=16, num_heads=2, attn_type="ring")


def test_export_decode_step_matches_jax(tmp_path):
    """The exported KV cell's symbol JSON is byte-identical to the JAX
    package's for the same net and its ``.params`` hold the same names and
    values; the port's ``Predictor`` over it, fed its cache outputs back,
    decodes the tokens of ``generate(kv_cache=True)`` exactly."""
    prompt = np.random.RandomState(3).randint(0, 32, (1, 6)).astype(
        np.float32)
    with mxj.name.NameManager(), mxt.name.NameManager():
        jnet, tnet = _pair(16, prompt)
    names = {}
    for k, net in (("jax", jnet), ("port", tnet)):
        # fresh name counters: the cell's node names must not depend on
        # the tests before
        with mxj.name.NameManager(), mxt.name.NameManager():
            names[k] = net.export_decode_step(str(tmp_path / k))
    assert names["port"] == names["jax"]
    texts = [(tmp_path / f"{k}-symbol.json").read_text()
             for k in ("jax", "port")]
    assert texts[0] == texts[1]
    want_p = mxj.nd.load(str(tmp_path / "jax-0000.params"))
    got_p = mxt.nd.load(str(tmp_path / "port-0000.params"), ctx=CPU)
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_array_equal(mxt.nd.asnumpy(got_p[k]),
                                      want_p[k].asnumpy())
    want = mxt.nd.asnumpy(tnet.generate(mxt.nd.array(prompt, ctx=CPU), 5,
                                        kv_cache=True))
    blk = tnet.blocks._children[0].attn
    cache = (1, blk._h, 16, blk._dh)
    shapes = {"data0": (1, 1), "data1": (1,)}
    shapes.update({n: cache for n in names["port"][2:]})
    pred = mxt.predictor.create(str(tmp_path / "port-symbol.json"),
                                str(tmp_path / "port-0000.params"), shapes,
                                dev=CPU)
    toks = list(prompt[0])
    for t in range(prompt.shape[1] + 5 - 1):
        pred.set_input("data0", np.array([[toks[t]]], np.float32))
        pred.set_input("data1", np.array([float(t)], np.float32))
        pred.forward()
        outs = pred.outputs
        for name, c in zip(names["port"][2:], outs[1:]):
            pred.set_input(name, c)
        if t + 1 >= prompt.shape[1]:
            toks.append(float(outs[0].argmax(-1)[0]))
    np.testing.assert_array_equal(np.array([toks], np.float32), want)
