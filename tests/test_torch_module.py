"""The port's symbolic training path against the JAX package's, on the CPU.

The same numpy inputs and seeds go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` (``ctx=cpu()``); the port's symbols are the JAX
package's, loaded from their JSON.  Covered: the loss-output ops (values
and gradients, 1e-6 in float32), ``simple_bind``/``bind``/``eval`` and the
executor's forward, backward with and without head gradients and
``grad_req="add"`` on a small conv + BatchNorm + FC symbol (outputs,
gradients and moving statistics within 1e-5 of each one's largest),
``Module.fit`` of a LeNet-shaped symbol on MNIST-shaped synthetic data
through the ``local`` and ``tpu_sync`` kvstores (parameters within 1e-4 of
each one's largest, equal metrics, ``score`` and ``predict``), checkpoints
either package reads (bitwise), ``Optimizer(sym=)``'s multipliers, the
kvstore, ``Monitor``, ``infer_type`` of ``resnet18_v1`` in bfloat16, and
the parts that are not ported naming their queue item.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import MXNetError

CPU = mxt.cpu()


def _np(x):
    return x.asnumpy() if isinstance(x, mxj.nd.NDArray) else \
        mxt.nd.asnumpy(x)


def _port(jsym):
    """The JAX package's symbol, loaded in the port from its JSON."""
    return mxt.sym.load_json(jsym.tojson())


def _close(got, want, tol):
    """max |got - want| within ``tol`` of max |want| (or of 1 when that
    is 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() or 1.0
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


# -- the loss-output ops ----------------------------------------------------
_SM = "SoftmaxOutput"
_LOSS_CASES = [
    ("softmax", _SM, {}, (4, 5), (4,)),
    ("softmax grad_scale", _SM, {"grad_scale": 2.5}, (4, 5), (4,)),
    ("softmax ignore valid", _SM, {"use_ignore": True, "ignore_label": 1,
                                   "normalization": "valid"}, (6, 5), (6,)),
    ("softmax ignore batch", _SM, {"use_ignore": True, "ignore_label": 2,
                                   "normalization": "batch"}, (6, 5), (6,)),
    ("softmax multi_output", _SM, {"multi_output": True}, (2, 5, 3), (2, 3)),
    ("softmax preserve_shape", _SM, {"preserve_shape": True}, (2, 3, 5),
     (2, 3)),
    ("softmax out_grad", _SM, {"out_grad": True, "grad_scale": 0.5}, (4, 5),
     (4,)),
    ("Softmax alias", "Softmax", {"normalization": "batch"}, (4, 5), (4,)),
    ("linear regression", "LinearRegressionOutput", {"grad_scale": 2.0},
     (4, 3), (4, 3)),
    ("logistic regression", "LogisticRegressionOutput", {}, (4, 3), (4, 3)),
    ("MAE regression", "MAERegressionOutput", {"grad_scale": 0.5}, (4, 3),
     (4, 3)),
    ("MakeLoss", "MakeLoss", {"grad_scale": 3.0, "normalization": "batch"},
     (4, 3), None),
    ("BlockGrad", "BlockGrad", {}, (4, 3), None),
    ("make_loss", "make_loss", {}, (4, 3), None),
]


def _loss_inputs(op, kw, dshape, lshape):
    rs = np.random.RandomState(0)
    feed = {"data": rs.normal(size=dshape).astype(np.float32)}
    if lshape is not None:
        if op in (_SM, "Softmax"):
            nclass = dshape[1] if kw.get("multi_output") else dshape[-1]
            feed["label"] = rs.randint(0, nclass, lshape).astype(np.float32)
        else:
            feed["label"] = rs.uniform(size=lshape).astype(np.float32)
    return feed, rs.normal(size=dshape).astype(np.float32)


def _loss_run(mx, ctx, sym, feed, head):
    """(output, d data) of a train-mode forward and a backward with
    ``head`` as the head gradient."""
    args = {k: mx.nd.array(v, ctx=ctx) for k, v in feed.items()}
    ex = sym.bind(ctx, args, args_grad={
        "data": mx.nd.zeros(feed["data"].shape, ctx=ctx)})
    out = _np(ex.forward(is_train=True)[0])
    ex.backward([mx.nd.array(head, ctx=ctx)])
    return out, _np(ex.grad_dict["data"])


@pytest.mark.parametrize("case", _LOSS_CASES, ids=[c[0] for c in _LOSS_CASES])
def test_loss_output_op_matches_jax(case):
    """Forward values and the folded gradient (the head gradient used only
    by ``out_grad`` and the identity ops), float32, within 1e-6."""
    _, op, kw, dshape, lshape = case
    with mxj.name.NameManager():
        ins = [mxj.sym.var("data")] + \
            ([mxj.sym.var("label")] if lshape is not None else [])
        jsym = getattr(mxj.sym, op)(*ins, **kw)
    feed, head = _loss_inputs(op, kw, dshape, lshape)
    want = _loss_run(mxj, mxj.cpu(), jsym, feed, head)
    got = _loss_run(mxt, CPU, _port(jsym), feed, head)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_softmax_output_label_shape_is_inferred():
    for kw, dshape, lshape in (({}, (4, 5), (4,)),
                               ({"multi_output": True}, (2, 5, 3), (2, 3)),
                               ({"preserve_shape": True}, (2, 3, 5), (2, 3))):
        sym = mxt.sym.SoftmaxOutput(mxt.sym.var("data"), name="sm", **kw)
        args, outs, _ = sym.infer_shape(data=dshape)
        assert args == [dshape, lshape] and outs == [dshape]
    reg = mxt.sym.LinearRegressionOutput(mxt.sym.var("data"), name="lr")
    assert reg.infer_shape(data=(4, 3))[0] == [(4, 3), (4, 3)]


# -- the executor -----------------------------------------------------------
def _small_net(mx):
    with mx.name.NameManager():
        x = mx.sym.Convolution(mx.sym.var("data"), num_filter=4,
                               kernel=(3, 3), no_bias=True, name="conv0")
        x = mx.sym.BatchNorm(x, fix_gamma=False, name="bn0")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Flatten(x)
        x = mx.sym.FullyConnected(x, num_hidden=5, name="fc1")
        return mx.sym.SoftmaxOutput(x, name="softmax")


_EX_SHAPES = {"data": (4, 2, 6, 6), "softmax_label": (4,)}


def _executor_feed(sym):
    rs = np.random.RandomState(3)
    arg_shapes, _, aux_shapes = sym.infer_shape(**_EX_SHAPES)
    feed = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        feed[n] = rs.randint(0, 5, s).astype(np.float32) \
            if n == "softmax_label" else rs.normal(size=s).astype(np.float32)
    aux = {n: (np.abs(rs.normal(size=s)) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    head = rs.normal(size=(4, 5)).astype(np.float32)
    return feed, aux, head


def _executor_run(mx, ctx, sym):
    """simple_bind: one train step without head gradients, one with, then
    grad_req="add" twice; bind + forward in inference; eval."""
    feed, aux, head = _executor_feed(sym)
    res = {}
    ex = sym.simple_bind(ctx, **_EX_SHAPES)
    ex.copy_params_from({k: mx.nd.array(v, ctx=ctx) for k, v in feed.items()},
                        {k: mx.nd.array(v, ctx=ctx) for k, v in aux.items()})
    res["out"] = _np(ex.forward(is_train=True)[0])
    ex.backward()
    res.update({"grad " + k: _np(v) for k, v in ex.grad_dict.items()})
    res.update({"aux " + k: _np(v) for k, v in ex.aux_dict.items()})
    ex.forward(is_train=True)
    ex.backward([mx.nd.array(head, ctx=ctx)])
    res.update({"head grad " + k: _np(v) for k, v in ex.grad_dict.items()})
    res["outputs"] = list(ex.output_dict)
    add = sym.simple_bind(ctx, grad_req="add", **_EX_SHAPES)
    add.copy_params_from({k: mx.nd.array(v, ctx=ctx)
                          for k, v in feed.items()})
    for _ in range(2):
        add.forward(is_train=True)
        add.backward()
    res.update({"add grad " + k: _np(v) for k, v in add.grad_dict.items()})
    args = {k: mx.nd.array(v, ctx=ctx) for k, v in feed.items()}
    auxs = {k: mx.nd.array(v, ctx=ctx) for k, v in aux.items()}
    res["bind inference"] = _np(sym.bind(ctx, args, aux_states=auxs)
                                .forward()[0])
    # eval binds no aux states: the convolution before the BatchNorm
    conv = sym.get_internals()["conv0_output"]
    res["eval"] = _np(conv.eval(ctx, **{k: args[k] for k in
                                        conv.list_arguments()})[0])
    return res


@pytest.fixture(scope="module")
def executor_runs():
    jsym = _small_net(mxj)
    return _executor_run(mxj, mxj.cpu(), jsym), \
        _executor_run(mxt, CPU, _port(jsym))


@pytest.mark.parametrize("what", ["out", "grad", "aux", "head grad",
                                  "add grad", "bind inference", "eval"])
def test_executor_matches_jax(executor_runs, what):
    """Outputs, gradients and moving statistics within 1e-5 of the
    largest of each."""
    want, got = executor_runs
    keys = [k for k in want if k == what or k.startswith(what + " ")]
    assert keys and got["outputs"] == want["outputs"] == ["softmax_output"]
    for k in keys:
        _close(got[k], want[k], 1e-5)


def test_executor_builds_a_graph_only_to_train():
    """Inference and a train-mode forward of an executor with no gradient
    to take build no autograd graph; a second backward needs a forward."""
    sym = _port(_small_net(mxj))
    feed, aux, _ = _executor_feed(sym)
    args = {k: mxt.nd.array(v, ctx=CPU) for k, v in feed.items()}
    ex = sym.bind(CPU, args, aux_states={
        k: mxt.nd.array(v, ctx=CPU) for k, v in aux.items()})
    assert ex.forward(is_train=True)[0].grad_fn is None
    assert ex._graph is None
    train = sym.simple_bind(CPU, **_EX_SHAPES)
    train.forward(is_train=True)
    assert train._graph is not None
    train.backward()
    with pytest.raises(MXNetError, match="once per forward"):
        train.backward()
    with pytest.raises(MXNetError, match="unknown forward argument"):
        train.forward(nope=args["data"])


def test_executor_reshape_and_monitor_callback():
    sym = _port(_small_net(mxj))
    ex = sym.simple_bind(CPU, **_EX_SHAPES)
    seen = []
    ex.set_monitor_callback(lambda n, a: seen.append((n, tuple(a.shape))),
                            monitor_all=True)
    ex.forward()
    assert ("softmax_output", (4, 5)) in seen and \
        ("data_input", (4, 2, 6, 6)) in seen
    small = ex.reshape(data=(2, 2, 6, 6), softmax_label=(2,))
    assert small.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    assert small.forward()[0].shape == (2, 5)


# -- Module.fit -------------------------------------------------------------
def _lenet(mx):
    with mx.name.NameManager():
        x = mx.sym.var("data")
        x = mx.sym.Convolution(x, num_filter=4, kernel=(5, 5), name="conv1")
        x = mx.sym.Activation(x, act_type="tanh")
        x = mx.sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
        x = mx.sym.Convolution(x, num_filter=8, kernel=(5, 5), no_bias=True,
                               name="conv2")
        x = mx.sym.BatchNorm(x, fix_gamma=False, name="bn2")
        x = mx.sym.Activation(x, act_type="tanh")
        x = mx.sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
        x = mx.sym.Flatten(x)
        x = mx.sym.FullyConnected(x, num_hidden=16, name="fc1")
        x = mx.sym.Activation(x, act_type="tanh")
        x = mx.sym.FullyConnected(x, num_hidden=10, name="fc2")
        return mx.sym.SoftmaxOutput(x, name="softmax")


_MNIST = np.random.RandomState(7)
_X = _MNIST.uniform(size=(64, 1, 28, 28)).astype(np.float32)
_Y = _MNIST.randint(0, 10, 64).astype(np.float32)
_X[np.arange(64), 0, 0, :10] += np.eye(10, dtype=np.float32)[_Y.astype(int)]


def _fit(mx, ctx, sym, kvstore):
    np.random.seed(1)                   # NDArrayIter's shuffle
    mx.random.seed(0)                   # the initializer's draws
    train = mx.io.NDArrayIter(_X, _Y, batch_size=16, shuffle=True)
    mod = mx.mod.Module(sym, context=ctx)
    batches = []
    mod.fit(train, num_epoch=2, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4},
            initializer=mx.init.Xavier(), eval_metric="acc",
            batch_end_callback=lambda p: batches.append(
                p.eval_metric.get()[1]))
    arg, aux = mod.get_params()
    params = {k: _np(v) for k, v in {**arg, **aux}.items()}
    test = mx.io.NDArrayIter(_X[:40], _Y[:40], batch_size=16)
    score = mod.score(test, mx.metric.create("acc"))
    pred = _np(mod.predict(test))
    return params, batches, score, pred, mod


@pytest.fixture(scope="module")
def lenet_fits():
    jsym = _lenet(mxj)
    tsym = _port(jsym)
    return {kv: (_fit(mxj, mxj.cpu(), jsym, kv), _fit(mxt, CPU, tsym, kv))
            for kv in ("local", "tpu_sync")}


@pytest.mark.parametrize("kvstore", ["local", "tpu_sync"])
def test_module_fit_matches_jax(lenet_fits, kvstore):
    """Two epochs of SGD with momentum and wd: every parameter and moving
    statistic within 1e-4 of its largest; the per-batch training accuracy,
    ``score`` and the predicted classes equal; ``predict`` drops the
    padded rows (40 samples in batches of 16)."""
    (jp, jb, js, jpred, jmod), (tp, tb, ts, tpred, tmod) = lenet_fits[kvstore]
    assert sorted(tp) == sorted(jp)
    for k in jp:
        _close(tp[k], jp[k], 1e-4)
    assert tb == jb and len(tb) == 8
    assert ts == js
    assert tpred.shape == jpred.shape == (40, 10)
    np.testing.assert_allclose(tpred, jpred, atol=1e-4)
    assert (tpred.argmax(1) == jpred.argmax(1)).all()
    assert (tmod._kvstore is not None) == (kvstore == "tpu_sync") == \
        tmod._update_on_kvstore


def test_module_update_routes_agree(lenet_fits):
    """The kvstore that updates on pushpull and the local Updater give
    bitwise the same weights."""
    local, tpu = lenet_fits["local"][1][0], lenet_fits["tpu_sync"][1][0]
    for k in local:
        np.testing.assert_array_equal(local[k], tpu[k])


def test_module_bind_dtypes_match_jax_in_bfloat16():
    """bf16 data: bf16 weights and float32 BatchNorm scale, shift and
    statistics, as the JAX module binds them; the label stays float32."""
    jsym = _lenet(mxj)
    got = {}
    for mx, ctx, sym in ((mxj, mxj.cpu(), jsym), (mxt, CPU, _port(jsym))):
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind([mx.io.DataDesc("data", (4, 1, 28, 28), "bfloat16")],
                 [mx.io.DataDesc("softmax_label", (4,), np.float32)])
        ex = mod._exec
        got[mx] = {k: str(np.dtype(mxt.base.np_dtype(v.dtype)))
                   for k, v in {**ex.arg_dict, **ex.aux_dict}.items()}
    assert got[mxt] == got[mxj]
    assert got[mxt]["conv1_weight"] == "bfloat16"
    assert got[mxt]["bn2_gamma"] == got[mxt]["bn2_moving_var"] == "float32"


def test_bf16_language_model_binds_bf16_weights():
    """A cast Gluon net's symbol carries bfloat16 in its parameters'
    ``__dtype__``: Module binds them bfloat16 behind float32 token ids
    (which no data dtype could give: bf16 ids above 256 round), the label
    float32; one training step through the executor."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(vocab=50, dim=16, num_layers=1, num_heads=2,
                        max_len=16, attn_type="flash")
    net.initialize(mxt.init.Xavier(), ctx=CPU)
    net(mxt.nd.array(np.zeros((1, 4), np.float32), ctx=CPU))
    net.cast("bfloat16")
    sym = mxt.sym.SoftmaxOutput(net(mxt.sym.var("data")),
                                preserve_shape=True, name="softmax")
    mod = mxt.mod.Module(sym, context=CPU)
    mod.bind([("data", (2, 16))], [("softmax_label", (2, 16))])
    args = mod._exec.arg_dict
    assert {args[n].dtype for n in mod._param_names} == {torch.bfloat16}
    assert args["data"].dtype == args["softmax_label"].dtype == torch.float32
    mod.init_params(arg_params={p.name: p.data()
                                for p in net.collect_params().values()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "multi_precision": True})
    ids = np.random.RandomState(0).randint(0, 50, (2, 17)).astype("f")
    mod.forward_backward(mxt.io.DataBatch([torch.from_numpy(ids[:, :-1])],
                                          [torch.from_numpy(ids[:, 1:])]))
    mod.update()
    assert mod.get_outputs()[0].dtype == torch.bfloat16


def test_module_forward_backward_update_by_hand():
    """The fit loop by hand: forward_backward and update, a partial batch
    (3 rows) rebinding the inputs' shape, get_outputs and
    get_input_grads."""
    sym = _port(_lenet(mxj))
    mod = mxt.mod.Module(sym, context=CPU)
    mod.bind([("data", (16, 1, 28, 28))], [("softmax_label", (16,))],
             inputs_need_grad=True)
    mod.init_params(mxt.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    before = mxt.nd.asnumpy(mod.get_params()[0]["fc2_weight"])
    batch = mxt.io.DataBatch([torch.from_numpy(_X[:16])],
                             [torch.from_numpy(_Y[:16])])
    mod.forward_backward(batch)
    mod.update()
    after = mxt.nd.asnumpy(mod.get_params()[0]["fc2_weight"])
    assert np.abs(after - before).max() > 0
    assert mod.get_input_grads()[0].shape == (16, 1, 28, 28)
    part = mxt.io.DataBatch([torch.from_numpy(_X[:3])],
                            [torch.from_numpy(_Y[:3])])
    mod.forward(part, is_train=False)
    assert mod.get_outputs()[0].shape == (3, 10)
    assert dict(mod.output_shapes) == {"softmax_output": (3, 10)}


# -- checkpoints ------------------------------------------------------------
def test_checkpoints_cross_packages_bitwise(lenet_fits, tmp_path):
    """A checkpoint written by either package loads in the other: the
    same graph JSON and bitwise the same arrays; ``Module.load`` binds
    and scores with it."""
    (jp, *_, jmod), (tp, *_, tmod) = lenet_fits["local"]
    jmod.save_checkpoint(str(tmp_path / "jax"), 2)
    tmod.save_checkpoint(str(tmp_path / "port"), 3)
    jsym, jarg, jaux = mxj.model.load_checkpoint(str(tmp_path / "port"), 3)
    tsym, targ, taux = mxt.model.load_checkpoint(str(tmp_path / "jax"), 2)
    assert tsym.tojson() == jmod.symbol.tojson()
    assert jsym.tojson() == tmod.symbol.tojson()
    for k, v in {**jarg, **jaux}.items():
        np.testing.assert_array_equal(v.asnumpy(), tp[k])
    for k, v in {**targ, **taux}.items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(mxt.nd.asnumpy(v), jp[k])
    mod = mxt.mod.Module.load(str(tmp_path / "jax"), 2, context=CPU)
    mod.bind([("data", (16, 1, 28, 28))], [("softmax_label", (16,))],
             for_training=False)
    test = mxt.io.NDArrayIter(_X[:40], _Y[:40], batch_size=16)
    assert mod.score(test, "acc") == lenet_fits["local"][0][2]
    tmod.save_params(str(tmp_path / "p.params"))
    jmod.load_params(str(tmp_path / "p.params"))
    for k, v in {**jmod.get_params()[0], **jmod.get_params()[1]}.items():
        np.testing.assert_array_equal(v.asnumpy(), tp[k])


def test_do_checkpoint_and_speedometer(tmp_path, caplog):
    sym = _port(_lenet(mxj))
    mod = mxt.mod.Module(sym, context=CPU)
    train = mxt.io.NDArrayIter(_X[:32], _Y[:32], batch_size=16)
    with caplog.at_level(logging.INFO):
        mod.fit(train, num_epoch=2, initializer=mxt.init.Xavier(),
                epoch_end_callback=mxt.callback.do_checkpoint(
                    str(tmp_path / "ck"), period=2),
                batch_end_callback=[mxt.callback.Speedometer(16, 1),
                                    mxt.callback.log_train_metric(1)])
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["ck-0002.params", "ck-symbol.json"]
    assert any("samples/sec" in r.getMessage() for r in caplog.records)


# -- optimizer, kvstore, monitor --------------------------------------------
def test_optimizer_reads_the_graphs_multipliers():
    def build(mx):
        with mx.name.NameManager():
            w = mx.sym.var("fc_weight", lr_mult=0.5, wd_mult=2.0)
            b = mx.sym.var("fc_bias", lr_mult=3.0)
            return mx.sym.FullyConnected(mx.sym.var("data"), weight=w,
                                         bias=b, num_hidden=2, name="fc")
    got = {}
    for mx in (mxj, mxt):
        o = mx.optimizer.create("sgd", sym=build(mx), learning_rate=0.1,
                                wd=0.01, param_idx2name={0: "fc_weight",
                                                         1: "fc_bias"})
        got[mx] = (o.lr_mult, o.wd_mult,
                   [(o._get_lr(i), o._get_wd(i)) for i in (0, 1)])
    assert got[mxt] == got[mxj]
    assert got[mxt][0] == {"fc_weight": 0.5, "fc_bias": 3.0}


def test_kvstore_push_pull_matches_jax():
    rs = np.random.RandomState(2)
    a, b, c = (rs.normal(size=(3, 4)).astype(np.float32) for _ in range(3))
    got = {}
    for mx, arr in ((mxj, mxj.nd.array),
                    (mxt, lambda v: mxt.nd.array(v, ctx=CPU))):
        kv = mx.kv.create("local")
        kv.init("w", arr(a))
        kv.init(3, arr(b))
        kv.push("w", [arr(b), arr(c)])          # two copies: summed
        out = arr(np.zeros((3, 4), np.float32))
        kv.pull("w", out=out)
        res = [_np(out)]
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
        outs = [arr(np.zeros((3, 4), np.float32)) for _ in range(2)]
        kv.pushpull(3, arr(c), out=outs)        # b - 0.5 * c, to both
        res += [_np(o) for o in outs]
        got[mx] = (res, kv.rank, kv.num_workers, kv.type)
    for g, w in zip(got[mxt][0], got[mxj][0]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[mxt][0][0], b + c, rtol=1e-6)
    assert got[mxt][1:] == got[mxj][1:] == (0, 1, "local")


def test_monitor_statistics_match_jax():
    jsym = _small_net(mxj)
    got = {}
    for mx, ctx, sym in ((mxj, mxj.cpu(), jsym),
                         (mxt, CPU, _port(jsym))):
        feed, aux, _ = _executor_feed(sym)
        ex = sym.simple_bind(ctx, **_EX_SHAPES)
        ex.copy_params_from({k: mx.nd.array(v, ctx=ctx)
                             for k, v in feed.items()},
                            {k: mx.nd.array(v, ctx=ctx)
                             for k, v in aux.items()})
        mon = mx.monitor.Monitor(1, pattern=".*", sort=True)
        mon.install(ex)
        rows = []
        for _ in range(2):
            mon.tic()
            ex.forward(is_train=False)
            rows += mon.toc()
        got[mx] = rows
    assert [r[:2] for r in got[mxt]] == [r[:2] for r in got[mxj]]
    assert len(got[mxt]) == 2 * (1 + len(jsym.list_arguments()))
    for t, j in zip(got[mxt], got[mxj]):
        np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=1e-5)


def test_resnet18_symbol_types_match_jax_in_bfloat16():
    """``infer_type`` of the model zoo's resnet18_v1 symbol with bf16 data:
    the same dtype for every argument, output and aux state."""
    got = {}
    for mx in (mxj, mxt):
        with mx.name.NameManager():
            net = mx.gluon.model_zoo.vision.resnet18_v1()
            sym = mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                       name="softmax")
        types = sym.infer_type(data="bfloat16")
        got[mx] = (sym.list_arguments(), sym.list_auxiliary_states(),
                   [[str(np.dtype(t)) for t in ts] for ts in types])
    assert got[mxt] == got[mxj]
    args, _, (arg_t, _, aux_t) = got[mxt]
    assert arg_t[args.index("softmax_label")] == "float32"
    assert set(aux_t) == {"float32"}


# -- other modules ----------------------------------------------------------
def test_sequential_and_python_loss_modules_match_jax():
    """A SequentialModule of a Module and a PythonLossModule: one
    forward/backward/update, the weights against the JAX package's."""
    def run(mx, ctx):
        with mx.name.NameManager():
            fc = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=3,
                                       name="fc")

        def grad_func(scores, labels):
            return (scores - labels) * 0.5

        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(fc, label_names=[], context=ctx))
        seq.add(mx.mod.PythonLossModule(grad_func=grad_func,
                                        label_names=["softmax_label"]),
                take_labels=True, auto_wiring=True)
        seq.bind([("data", (4, 5))], [("softmax_label", (4, 3))])
        mx.random.seed(0)
        seq.init_params(mx.init.Xavier())
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        rs = np.random.RandomState(4)
        x = mx.nd.array(rs.normal(size=(4, 5)).astype(np.float32), ctx=ctx)
        y = mx.nd.array(rs.normal(size=(4, 3)).astype(np.float32), ctx=ctx)
        seq.forward(mx.io.DataBatch([x], [y]), is_train=True)
        seq.backward()
        seq.update()
        return {k: _np(v) for k, v in seq.get_params()[0].items()}
    want, got = run(mxj, mxj.cpu()), run(mxt, CPU)
    for k in want:
        _close(got[k], want[k], 1e-5)


def test_feedforward_fits_like_module():
    """The legacy FeedForward delegates to Module: the same weights as the
    JAX package's FeedForward."""
    jsym = _lenet(mxj)
    got = {}
    for mx, ctx, sym in ((mxj, mxj.cpu(), jsym), (mxt, CPU, _port(jsym))):
        np.random.seed(1)
        mx.random.seed(0)
        model = mx.model.FeedForward(sym, ctx=ctx, num_epoch=1,
                                     numpy_batch_size=16,
                                     initializer=mx.init.Xavier(),
                                     learning_rate=0.1)
        model.fit(_X[:32], _Y[:32])
        got[mx] = ({k: _np(v) for k, v in model.arg_params.items()},
                   model.predict(_X[:20]))
    for k in got[mxj][0]:
        _close(got[mxt][0][k], got[mxj][0][k], 1e-4)
    assert got[mxt][1].shape == (20, 10)
    np.testing.assert_allclose(got[mxt][1], got[mxj][1], atol=1e-4)


# -- devices and the parts that are not ported ------------------------------
def test_module_without_cuda_raises():
    """With no CUDA device and no explicit cpu(), binding raises; nothing
    runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: gpu(0) is valid here")
    sym = _port(_lenet(mxj))
    with pytest.raises(MXNetError, match="not available"):
        mxt.mod.Module(sym).bind([("data", (4, 1, 28, 28))],
                                 [("softmax_label", (4,))])
    with pytest.raises(MXNetError, match="not available"):
        sym.simple_bind(mxt.current_context(), data=(4, 1, 28, 28))
    with pytest.raises(MXNetError, match="not available"):
        sym.eval(data=mxt.nd.array(_X[:4], ctx=CPU))


def test_parts_not_ported_name_their_roadmap_item(monkeypatch, tmp_path):
    sym = _port(_lenet(mxj))
    mod = mxt.mod.Module(sym, context=CPU)
    mod.bind([("data", (16, 1, 28, 28))], [("softmax_label", (16,))])
    mod.init_params(mxt.init.Xavier())
    mod.init_optimizer()
    calls = [
        (lambda: mxt.mod.Module(sym, context=[CPU, mxt.cpu(1)]), "item 6"),
        (lambda: mxt.kv.create("dist_sync"), "item 6"),
        (lambda: mod.save_checkpoint(str(tmp_path / "c"), 1,
                                     reference_format=True), "item 6"),
        (lambda: mxt.callback.do_checkpoint("p", reference_format=True),
         "item 6"),
        (lambda: mxt.io.LibSVMIter("x.libsvm", (4,)), "item 6"),
        (lambda: sym.simple_bind(CPU, group2ctx={"a": CPU},
                                 data=(2, 1, 28, 28)), "item 6"),
    ]
    for call, item in calls:
        with pytest.raises(NotImplementedError, match=item):
            call()
    # ported since: the optimizer-state files and fit's checkpoint_dir
    mod.save_optimizer_states(str(tmp_path / "s"))
    mod.load_optimizer_states(str(tmp_path / "s"))
    it = mxt.io.NDArrayIter(_X[:16], _Y[:16], batch_size=16)
    mod.fit(it, num_epoch=1, checkpoint_dir=str(tmp_path / "d"))
    assert mxt.checkpoint.all_steps(str(tmp_path / "d")) == [1]
    # ported since: gradient compression and MXNET_FUSED_STEP (item 4)
    kv = mxt.kv.create("device")
    kv.set_gradient_compression({"type": "2bit"})
    kv.init(0, mxt.nd.zeros((4,), ctx=CPU))
    kv.push(0, mxt.nd.array([0.7, -0.2, -0.9, 0.1], ctx=CPU))
    got = mxt.nd.zeros((4,), ctx=CPU)
    kv.pull(0, out=got)
    np.testing.assert_array_equal(_np(got), [0.5, 0.0, -0.5, 0.0])
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    mod.init_optimizer(force_init=True)
    before = _np(mod._exec.arg_dict["fc2_weight"]).copy()
    mod.forward_backward(mxt.io.DataBatch([mxt.nd.array(_X[:16], ctx=CPU)],
                                          [mxt.nd.array(_Y[:16], ctx=CPU)]))
    mod.update()
    assert mod._fused_step_eligible() and mod._fstep_graph is not None
    assert not np.array_equal(_np(mod._exec.arg_dict["fc2_weight"]), before)
    monkeypatch.delenv("MXNET_FUSED_STEP")
    # ported since: the record iterators and the mirror (item 10)
    imgs = np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3))
    rec = mxt.recordio.MXRecordIO(str(tmp_path / "x.rec"), "w")
    for i, img in enumerate(imgs.astype(np.uint8)):
        rec.write(mxt.recordio.pack_img((0, float(i), i, 0), img,
                                        img_fmt=".npy"))
    rec.close()
    batch = next(iter(mxt.io.ImageRecordIter(str(tmp_path / "x.rec"),
                                             (3, 8, 8), 2, ctx=CPU)))
    np.testing.assert_array_equal(_np(batch.data[0]),      # BGR -> RGB
                                  imgs[..., ::-1].transpose(0, 3, 1, 2))
    ex = sym.simple_bind(CPU, data=(2, 1, 28, 28))
    want = _np(ex.forward(is_train=True, data=_X[:2])[0])
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    ex = sym.simple_bind(CPU, data=(2, 1, 28, 28))
    np.testing.assert_array_equal(
        _np(ex.forward(is_train=True, data=_X[:2])[0]), want)
    ex.backward()


# -- backward mirroring (MXNET_BACKWARD_DO_MIRROR) ----------------------------
def _mirror_step(mx, ctx, jsym, monkeypatch, mirror):
    """One Module forward_backward + SGD update of LeNet (BatchNorm) from
    seeded weights: (parameters, moving statistics) after it."""
    if mirror:
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    else:
        monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    sym = jsym if mx is mxj else _port(jsym)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (16, 1, 28, 28))], [("softmax_label", (16,))])
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=(16, 1, 28, 28))
    rs = np.random.RandomState(4)
    args = {n: mx.nd.array(rs.normal(0, 0.2, s).astype(np.float32), ctx=ctx)
            for n, s in zip(jsym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: mx.nd.array(np.full(s, 0.5 if "var" in n else 0.1,
                                   np.float32), ctx=ctx)
            for n, s in zip(jsym.list_auxiliary_states(), aux_shapes)}
    mod.init_params(arg_params=args, aux_params=auxs)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    batch = mx.io.DataBatch([mx.nd.array(_X[:16], ctx=ctx)],
                            [mx.nd.array(_Y[:16], ctx=ctx)])
    mod.forward_backward(batch)
    mod.update()
    arg, aux = mod.get_params()
    return {k: _np(v) for k, v in arg.items()}, \
        {k: _np(v) for k, v in aux.items()}


def test_mirrored_module_step_matches_unmirrored_and_jax(monkeypatch):
    """A mirrored Module step on LeNet with BatchNorm gives the unmirrored
    step's parameters and moving statistics bitwise (the statistics moved
    once, from the first run of their segment), and the JAX package's
    mirrored step within 1e-5 of each one's largest."""
    jsym = _lenet(mxj)
    plain = _mirror_step(mxt, CPU, jsym, monkeypatch, False)
    mirrored = _mirror_step(mxt, CPU, jsym, monkeypatch, True)
    want = _mirror_step(mxj, mxj.cpu(), jsym, monkeypatch, True)
    for got, ref in zip(mirrored, plain):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    mean = plain[1]["bn2_moving_mean"]
    assert not np.allclose(mean, 0.1)
    for got, ref in zip(mirrored, want):
        for k in ref:
            _close(got[k], ref[k], 1e-5)


@pytest.mark.parametrize("segments", [None, "3", "5"])
@pytest.mark.parametrize("net", ["lenet", "small"])
def test_mirror_segment_count_matches_jax(monkeypatch, segments, net):
    """The executor's segment count is the JAX executor's:
    ``MXNET_MIRROR_SEGMENTS``, else max(2, int(sqrt(steps)))."""
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    if segments:
        monkeypatch.setenv("MXNET_MIRROR_SEGMENTS", segments)
    jsym = _lenet(mxj) if net == "lenet" else _small_net(mxj)
    shape = (2, 1, 28, 28) if net == "lenet" else (2, 2, 6, 6)
    jex = jsym.simple_bind(mxj.cpu(), data=shape)
    tex = _port(jsym).simple_bind(CPU, data=shape)
    assert tex._segments == jex._mirror_segments
    monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR")
    assert _port(jsym).simple_bind(CPU, data=shape)._segments == 1
