"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs and weights go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` (``ctx=cpu()``): the losses (values and gradients),
the five update ops (one step), the learning-rate schedulers, and the
training step of ``experiments/lm_mfu_probe.py`` (``TrainStep``: the
flash-attention TransformerLM and an f32 cross-entropy as one hybridized
block, ``autograd.record()``, ``backward``, ``Trainer.step``) on a 2-layer,
dim-32 model whose weights both packages take from the JAX net.

Tolerances: losses and their gradients 1e-5 (float32 in both, summed in
another order); an update op 1e-6 (the same expression on the same
inputs); three training steps: per-step losses 1e-5 relative and weights
within 1e-4 (rtol and atol) after the third; one bfloat16
``multi_precision`` step 3e-2 (the reference's bf16 pin), and its
optimizer state against each package's own gradient at 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM

CPU = mxt.cpu()
KW = dict(vocab=32, dim=32, num_layers=2, num_heads=4, max_len=16,
          attn_type="flash")
BATCH = 2


def _to_np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else mxt.nd.asnumpy(x)


# -- losses -----------------------------------------------------------------
def _loss_inputs(name, rs):
    pred = rs.randn(4, 5).astype("f")
    if name == "SoftmaxCrossEntropyLoss":
        return pred, rs.randint(0, 5, (4,)).astype("f")
    if name in ("KLDivLoss", "SoftmaxCELoss"):
        p = np.exp(rs.randn(4, 5))
        return pred, (p / p.sum(-1, keepdims=True)).astype("f")
    if name == "SigmoidBinaryCrossEntropyLoss":
        return pred, (rs.rand(4, 5) > 0.5).astype("f")
    if name in ("HingeLoss", "SquaredHingeLoss", "LogisticLoss"):
        return pred, np.sign(rs.randn(4, 5)).astype("f")
    if name == "TripletLoss":
        return pred, rs.randn(4, 5).astype("f"), rs.randn(4, 5).astype("f")
    return pred, rs.randn(4, 5).astype("f")


_LOSSES = [("L2Loss", {}), ("L1Loss", {}),
           ("SigmoidBinaryCrossEntropyLoss", {}),
           ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}),
           ("SoftmaxCrossEntropyLoss", {}),
           ("SoftmaxCELoss", {"sparse_label": False}),
           ("KLDivLoss", {"from_logits": False}), ("HuberLoss", {"rho": 0.7}),
           ("HingeLoss", {}), ("SquaredHingeLoss", {}),
           ("LogisticLoss", {}), ("TripletLoss", {"margin": 0.5}),
           ("L2Loss", {"weight": 0.5, "batch_axis": 1})]


@pytest.mark.parametrize("name,kw", _LOSSES,
                         ids=[f"{n}{sorted(k.items())}" for n, k in _LOSSES])
def test_loss_matches_jax(name, kw):
    arrays = _loss_inputs(name, np.random.RandomState(0))
    if kw.get("from_sigmoid"):
        arrays = (1 / (1 + np.exp(-arrays[0])), arrays[1])
    sample_weight = np.random.RandomState(1).rand(4, 1).astype("f")
    out = {}
    for mx, array in ((mxj, mxj.nd.array),
                      (mxt, lambda a: mxt.nd.array(a, ctx=CPU))):
        loss = getattr(mx.gluon.loss, name)(**kw)
        xs = [array(a) for a in arrays]
        pred = xs[0]
        if mx is mxj:
            pred.attach_grad()
        else:
            mxt.nd.attach_grad(pred)
        extra = () if name == "TripletLoss" or kw.get("batch_axis") else \
            (array(sample_weight),)
        with mx.autograd.record():
            value = loss(*xs, *extra)
        mx.autograd.backward([value])
        grad = pred.grad if mx is mxj else mxt.nd.grad(pred)
        out[mx] = (_to_np(value), _to_np(grad))
    for got, want in zip(out[mxt], out[mxj]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_hybridized_loss_matches_eager():
    """A loss traced to a Symbol graph (``reshape_like``, ``pick``,
    ``mean(exclude=True)`` as graph ops) gives the eager values."""
    rs = np.random.RandomState(2)
    pred = mxt.nd.array(rs.randn(3, 4, 6).astype("f"), ctx=CPU)
    label = mxt.nd.array(rs.randint(0, 6, (3, 4)).astype("f"), ctx=CPU)
    for loss in (mxt.gluon.loss.SoftmaxCELoss(),
                 mxt.gluon.loss.L1Loss()):
        args = (pred, label) if isinstance(
            loss, mxt.gluon.loss.SoftmaxCELoss) else (pred, pred * 0.5)
        eager = loss(*args)
        loss.hybridize()
        torch.testing.assert_close(loss(*args), eager, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["sum", "mean", "prod", "max", "min",
                                "nansum", "nanprod", "pick", "reshape_like"])
def test_training_ops_run_through_the_symbol_graph(op):
    """Each op of the losses and the TrainStep, traced to a Symbol graph
    and run by ``GraphPlan``, gives the eager values."""
    from mxnet_tpu_torch.symbol.graph import GraphPlan
    rs = np.random.RandomState(6)
    x = mxt.nd.array(rs.randn(2, 3, 4).astype("f"), ctx=CPU)
    other = {"pick": mxt.nd.array(rs.randint(0, 4, (2, 3)).astype("f"),
                                  ctx=CPU),
             "reshape_like": mxt.nd.zeros((4, 6), ctx=CPU)}.get(op)
    kw = {"pick": {"axis": -1}, "reshape_like": {}}.get(
        op, {"axis": 1, "keepdims": True, "exclude": True})
    inputs = [x] if other is None else [x, other]
    names = ["x", "y"][:len(inputs)]
    sym = getattr(mxt.sym, op)(*[mxt.sym.var(n) for n in names], **kw)
    (got,), _ = GraphPlan(sym).run(dict(zip(names, inputs)))
    torch.testing.assert_close(got, getattr(mxt.nd, op)(*inputs, **kw))


def test_train_mode_reaches_the_cached_graph():
    """``autograd.train_mode()`` reaches the ops of a hybridized block
    through its ``CachedOp``: a Dropout of rate 0.5 is the identity in
    predict mode and, in train mode, drops values and scales the kept ones
    by 2."""
    drop = mxt.gluon.nn.Dropout(0.5)
    drop.hybridize()
    x = mxt.nd.array(np.ones((8, 16), "f"), ctx=CPU)
    assert torch.equal(drop(x), x)
    with mxt.autograd.train_mode():
        out = drop(x)
    assert set(out.unique().tolist()) == {0.0, 2.0}


def test_ctc_loss_names_its_roadmap_item():
    """Ported since (ROADMAP item 7a): ``CTCLoss`` runs, on the CPU when
    asked, and gives one finite loss per sequence."""
    loss = mxt.gluon.loss.CTCLoss()
    pred = mxt.nd.array(np.zeros((2, 5, 4), np.float32), ctx=CPU)
    label = mxt.nd.array([[0, 1], [2, -1]], ctx=CPU)
    out = loss(pred, label)
    assert out.shape == (2,) and bool(torch.isfinite(out).all())


# -- update ops -------------------------------------------------------------
_UPDATES = [
    ("sgd_update", [], dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    ("sgd_mom_update", ["mom"], dict(lr=0.1, wd=0.01, momentum=0.9,
                                     clip_gradient=0.3)),
    ("mp_sgd_update", ["w32"], dict(lr=0.1, wd=0.01)),
    ("mp_sgd_mom_update", ["mom", "w32"], dict(lr=0.1, momentum=0.9,
                                               rescale_grad=2.0)),
    ("adam_update", ["mean", "var"], dict(lr=0.01, wd=0.01,
                                          clip_gradient=0.5))]


@pytest.mark.parametrize("op,states,kw", _UPDATES,
                         ids=[u[0] for u in _UPDATES])
def test_update_op_matches_jax(op, states, kw):
    rs = np.random.RandomState(3)
    weight, grad = rs.randn(2, 5, 3).astype("f")
    init = {"mom": rs.randn(5, 3).astype("f"), "w32": weight.copy(),
            "mean": rs.randn(5, 3).astype("f"),
            "var": rs.rand(5, 3).astype("f")}
    dtype = "bfloat16" if op.startswith("mp_") else "float32"
    jargs = [mxj.nd.array(weight).astype(dtype),
             mxj.nd.array(grad).astype(dtype)] + \
        [mxj.nd.array(init[s]) for s in states]
    targs = [mxt.nd.array(weight, ctx=CPU, dtype=dtype),
             mxt.nd.array(grad, ctx=CPU, dtype=dtype)] + \
        [mxt.nd.array(init[s], ctx=CPU) for s in states]
    getattr(mxj.nd, op)(*jargs, **kw)
    out = getattr(mxt.nd, op)(*targs, **kw)
    assert out is targs[0]              # the weight, written in place
    for t, j in zip(targs, jargs):
        np.testing.assert_allclose(_to_np(t).astype("f"),
                                   _to_np(j).astype("f"), rtol=1e-6,
                                   atol=1e-6)


# -- learning-rate schedulers -----------------------------------------------
@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(step=3, factor=0.5, stop_factor_lr=1e-3),
    lambda m: m.MultiFactorScheduler(step=[2, 5], factor=0.1),
    lambda m: m.PolyScheduler(max_update=8, base_lr=0.1, pwr=2),
    lambda m: m.CosineScheduler(max_update=8, base_lr=0.1, final_lr=0.01,
                                warmup_steps=2)],
    ids=["factor", "multifactor", "poly", "cosine"])
def test_lr_scheduler_matches_jax(make):
    j, t = make(mxj.lr_scheduler), make(mxt.lr_scheduler)
    assert [t(n) for n in range(12)] == [j(n) for n in range(12)]


# -- the training step ------------------------------------------------------
def _train_step(mx, net):
    """``experiments/lm_mfu_probe.py``'s TrainStep in package ``mx``."""
    class TrainStep(mx.gluon.HybridBlock):
        def __init__(self, net, vocab, **kw):
            super().__init__(**kw)
            self._v = vocab
            with self.name_scope():
                self.net = net

        def hybrid_forward(self, F, tokens, labels):
            logits = self.net(tokens)
            logits = F.cast(F.reshape(logits, (-1, self._v)), "float32")
            lp = F.log_softmax(logits, axis=-1)
            nll = -F.pick(lp, F.reshape(labels, (-1,)), axis=-1)
            return F.mean(nll)

    step = TrainStep(net, KW["vocab"])
    step.hybridize()
    return step


@pytest.fixture(scope="module")
def pair():
    """(JAX step, port step, the JAX weights as numpy, x, y): the port's
    weights are loaded from the JAX net's."""
    rs = np.random.RandomState(0)
    toks = rs.randint(0, KW["vocab"], (BATCH, KW["max_len"] + 1)).astype("f")
    mxj.random.seed(0)
    jnet = JaxLM(**KW)
    jnet.initialize(mxj.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    jstep = _train_step(mxj, jnet)
    # the step's first call resolves the deferred shapes (and compiles the
    # graph the training tests run)
    jstep(mxj.nd.array(toks[:, :-1]), mxj.nd.array(toks[:, 1:]))
    weights = {n: p.data().asnumpy()
               for n, p in jnet.collect_params().items()}
    tnet = TransformerLM(**KW)
    tnet.initialize(ctx=CPU)
    params_from_mxnet_tpu(weights, tnet, prefix=jnet.prefix)
    return (jstep, _train_step(mxt, tnet), weights, toks[:, :-1],
            toks[:, 1:])


def _reset(jstep, tstep, weights, dtype="float32"):
    for n, p in jstep.collect_params().items():
        p.set_data(mxj.nd.array(weights[n]).astype(dtype))
    params_from_mxnet_tpu(weights, tstep.net, prefix=jstep.net.prefix)
    if dtype != "float32":
        jstep.cast(dtype)
        tstep.cast(dtype)


def _run(mx, step, x, y, optimizer, opt_params, steps):
    array = mxj.nd.array if mx is mxj else (
        lambda a: mxt.nd.array(a, ctx=CPU))
    trainer = mx.gluon.Trainer(step.collect_params(), optimizer,
                               dict(opt_params))
    x, y = array(x), array(y)
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = step(x, y)
        loss.backward()
        trainer.step(BATCH)
        losses.append(float(_to_np(loss)))
    params = {n[len(step.net.prefix):]: _to_np(p.data()).astype("f")
              for n, p in step.collect_params().items()}
    return losses, params, trainer


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3})], ids=["sgd", "adam"])
def test_three_steps_match_jax_trainer(pair, optimizer, opt_params):
    """Adam: the key third of each ``qkv_bias`` has a zero gradient in
    exact arithmetic (softmax is invariant to a shift of a query's
    scores), so both packages' gradients there are float noise (about
    1e-8) that Adam normalizes into steps of up to lr either way.  Those
    entries are held to Adam's step bound, 1.5 lr per step, from where
    they started; every other entry to 1e-4."""
    jstep, tstep, weights, x, y = pair
    _reset(jstep, tstep, weights)
    jl, jp, _ = _run(mxj, jstep, x, y, optimizer, opt_params, 3)
    tl, tp, _ = _run(mxt, tstep, x, y, optimizer, opt_params, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert tp.keys() == jp.keys()
    if optimizer == "adam":
        d = KW["dim"]
        for n in [n for n in jp if n.endswith("attn_qkv_bias")]:
            start = weights[jstep.net.prefix + n][d:2 * d]
            for p in (tp, jp):
                assert np.abs(p[n][d:2 * d] - start).max() <= \
                    1.5 * 3 * opt_params["learning_rate"]
                p[n] = np.concatenate([p[n][:d], p[n][2 * d:]])
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)


def test_bf16_multi_precision_step_matches_jax(pair):
    """Both packages in bfloat16 with float32 masters, one SGD step.
    Losses and weights agree at the bf16 pin.  One step moves a weight by
    about a bf16 ulp, below that pin, so the update is also held where it
    shows, in each package's Trainer state against its own gradient: the
    momentum is the step, -lr * rescale_grad * grad (momentum starts at 0,
    wd is 0); the master is the bf16 start plus it; the bf16 weight is the
    master rounded.  The two packages' bf16 gradients are not compared
    with each other: each differs from the float32 gradient by up to about
    a quarter of its largest entry (float rounding through two bf16
    layers), and from the other by as much."""
    jstep, tstep, weights, x, y = pair
    _reset(jstep, tstep, weights, "bfloat16")
    try:
        lr, rescale = 0.1, 1.0 / BATCH
        opt = {"learning_rate": lr, "momentum": 0.9,
               "multi_precision": True}
        jl, jp, jtrainer = _run(mxj, jstep, x, y, "sgd", opt, 1)
        tl, tp, trainer = _run(mxt, tstep, x, y, "sgd", opt, 1)
        assert tstep.net.head.weight.data().dtype == torch.bfloat16
        np.testing.assert_allclose(tl, jl, rtol=3e-2, atol=3e-2)
        for n in jp:
            np.testing.assert_allclose(tp[n], jp[n], rtol=3e-2, atol=3e-2,
                                       err_msg=n)
        for step, tr, states in (
                (jstep, jtrainer, jtrainer._updaters[0].states),
                (tstep, trainer, trainer._updater.states)):
            assert sorted(states) == list(range(len(tr._params)))
            for i, p in enumerate(tr._params):
                name = jstep.net.prefix + p.name[len(step.net.prefix):]
                start = torch.from_numpy(weights[name]).bfloat16().float()
                mom, w32 = (torch.from_numpy(np.asarray(_to_np(s)))
                            for s in states[i])
                grad = torch.from_numpy(_to_np(p.grad()).astype("f"))
                assert mom.dtype == w32.dtype == torch.float32, name
                assert mom.abs().max() > 0, name
                torch.testing.assert_close(mom, -lr * rescale * grad,
                                           rtol=1e-6, atol=0, msg=name)
                torch.testing.assert_close(w32, start + mom, rtol=1e-6,
                                           atol=1e-7, msg=name)
                assert torch.equal(
                    torch.from_numpy(_to_np(p.data()).astype("f")),
                    w32.bfloat16().float()), name
    finally:
        jstep.cast("float32")
        tstep.cast("float32")


def test_stale_gradient_raises_as_in_jax():
    """Two Dense layers in one Trainer, a loss through the first only: the
    second's gradient is stale, and ``step`` raises ``UserWarning`` in both
    packages; ``ignore_stale_grad=True`` updates the first and leaves the
    second."""
    x = np.random.RandomState(4).randn(2, 3).astype("f")
    for mx, array in ((mxj, mxj.nd.array),
                      (mxt, lambda a: mxt.nd.array(a, ctx=CPU))):
        used, unused = mx.gluon.nn.Dense(2), mx.gluon.nn.Dense(2)
        for blk in (used, unused):
            blk.initialize(ctx=mx.cpu())
            blk(array(x))
        params = list(used.collect_params().values()) + \
            list(unused.collect_params().values())
        trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
        before = [_to_np(p.data()) for p in params]
        with mx.autograd.record():
            loss = used(array(x)).sum()
        loss.backward()
        with pytest.raises(UserWarning, match="has not been updated"):
            trainer.step(2)
        trainer.step(2, ignore_stale_grad=True)
        after = [_to_np(p.data()) for p in params]
        assert [np.array_equal(b, a) for b, a in zip(before, after)] == \
            [False, False, True, True]


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_parameter_grad_buffers_match_jax(grad_req):
    """``grad()`` is zeros before any backward; two backwards overwrite
    ("write") or accumulate ("add"); ``list_grad`` holds the buffer;
    ``zero_grad`` clears it; ``grad_req="null"`` has no gradient."""
    x = np.random.RandomState(5).randn(2, 3).astype("f")
    out = {}
    for mx, array in ((mxj, mxj.nd.array),
                      (mxt, lambda a: mxt.nd.array(a, ctx=CPU))):
        dense = mx.gluon.nn.Dense(2, in_units=3)
        dense.initialize(ctx=mx.cpu())
        w = dense.weight
        w.grad_req = grad_req
        seen = [_to_np(w.grad())]
        for k in (1.0, 3.0):
            with mx.autograd.record():
                loss = (dense(array(x)) * k).sum()
            loss.backward()
            seen.append(_to_np(w.list_grad()[0]))
        w.zero_grad()
        seen.append(_to_np(w.grad()))
        dense.bias.grad_req = "null"
        with pytest.raises(Exception, match="grad_req='null'"):
            dense.bias.grad()
        out[mx] = seen
    assert not out[mxt][0].any() and not out[mxt][-1].any()
    for got, want in zip(out[mxt], out[mxj]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_trainer_parts_not_ported_name_their_roadmap_item(pair, tmp_path):
    params = pair[1].collect_params()
    dense = mxt.gluon.nn.Dense(2, in_units=3)
    dense.initialize(ctx=[mxt.cpu(0), mxt.cpu(1)])
    two_devices = dense.collect_params()
    for call in (lambda: mxt.gluon.Trainer(params, "sgd",
                                           kvstore="dist_sync"),
                 lambda: mxt.gluon.Trainer(two_devices, "sgd").step(1)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    # ported since: save_states / load_states
    fname = str(tmp_path / "t.states")
    mxt.gluon.Trainer(params, "sgd").save_states(fname)
    loaded = mxt.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    loaded.load_states(fname)
    assert loaded.learning_rate == 0.01      # the saved optimizer's
    # ported since: compression (item 4); a state file with its residuals
    dense = mxt.gluon.nn.Dense(2, in_units=3)
    dense.initialize(ctx=mxt.cpu())
    comp = mxt.gluon.Trainer(dense.collect_params(), "sgd",
                             kvstore="tpu_sync", update_on_kvstore=False,
                             compression_params={"type": "2bit"})
    with mxt.autograd.record():
        y = dense(mxt.nd.ones((4, 3), ctx=mxt.cpu()))
    y.backward()
    comp.step(4)
    assert comp._residuals is not None and comp._kv._gc is not None
    comp.save_states(fname)
    comp.load_states(fname)
    assert comp._pending_residuals is None and comp._residuals is not None


@pytest.mark.parametrize("update_on_kvstore", [None, False],
                         ids=["update on the store", "reduce only"])
def test_trainer_with_a_one_device_kvstore_matches_none(update_on_kvstore):
    """Three SGD-momentum steps through ``Trainer(kvstore=
    mx.kv.create("device"))``, the optimizer on the store or only the
    reduce there, give bitwise the weights of ``kvstore=None``."""
    x = mxt.nd.array(np.random.RandomState(6).randn(5, 4).astype("f"),
                     ctx=CPU)
    weights = []
    for kv in (None, mxt.kv.create("device")):
        mxt.random.seed(0)
        net = mxt.gluon.nn.Dense(3, in_units=4)
        net.initialize(mxt.init.Xavier(), ctx=CPU)
        trainer = mxt.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
            kvstore=kv, update_on_kvstore=update_on_kvstore)
        for _ in range(3):
            with mxt.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            trainer.step(5)
        assert (trainer._kv is None) == (kv is None)
        weights.append([_to_np(p.data())
                        for p in net.collect_params().values()])
    for got, want in zip(*weights):
        np.testing.assert_array_equal(got, want)
