"""The port's one-program training step against its own fused path and
against the JAX package, on the CPU.

``WholeStepCompiler`` (``MXNET_WHOLE_STEP=1``) runs its step function
eagerly on the CPU: the plain version of the CUDA graph the card replays.
Held here: the whole step equals the port's fused path (record, backward,
``Trainer.step``) bitwise over 5 steps, with SGD, Adam, 2-bit compression
and a BatchNorm net; it follows the JAX package's ``WholeStepCompiler``
from the same weights (float32 within 1e-5 relative; ``MXNET_AMP=bf16``
within 0.08 and ``fp16`` within 0.05, the reference's own tolerances,
``tests/test_wholestep.py:33``), with the JAX package's loss-scale
sequence; a JAX trainer state file carrying residuals and a scaler
continues the JAX run in the port; ``MXNET_FUSED_STEP``'s eligibility
matches the JAX Module's, with one warning; a superstep equals K
sequential steps bitwise, and K resolves as in the JAX package; the
autotune decisions persist and hash as the JAX package's do.
"""
import contextlib
import json
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.autotune import decisions as jdec
from mxnet_tpu.gluon.wholestep import WholeStepCompiler as JaxWholeStep
from mxnet_tpu.gluon.wholestep import amp_policy as jax_amp_policy
from mxnet_tpu_torch.autotune import SuperStepCompiler
from mxnet_tpu_torch.autotune import decisions as tdec
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler, amp_policy

CPU = mxt.cpu()
BF16_TOL = 0.08
FP16_TOL = 0.05


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No step variable leaks in; one intra-op thread, so that the bitwise
    comparisons do not depend on how a loaded host splits a reduction."""
    for k in ("MXNET_WHOLE_STEP", "MXNET_AMP", "MXNET_SUPERSTEP_K",
              "MXNET_LOSS_SCALE_INIT", "MXNET_LOSS_SCALE_WINDOW",
              "MXNET_FUSED_STEP", "MXNET_BUCKET_SIZE_MB"):
        monkeypatch.delenv(k, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ctx(mx):
    return CPU if mx is mxt else mxj.cpu()


def _array(mx, a):
    return mx.nd.array(a, ctx=CPU) if mx is mxt else mx.nd.array(a)


def _mlp(mx, seed=11):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        for _ in range(4):
            net.add(mx.gluon.nn.Dense(8, activation="relu"))
        net.add(mx.gluon.nn.Dense(1))
    net.hybridize()
    net.initialize(mx.init.Xavier(), ctx=_ctx(mx))
    return net


def _cnn(mx, seed=7):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, kernel_size=3, padding=1))
        net.add(mx.gluon.nn.BatchNorm())
        net.add(mx.gluon.nn.Activation("relu"))
        net.add(mx.gluon.nn.Flatten())
        net.add(mx.gluon.nn.Dense(3))
    net.hybridize()
    net.initialize(mx.init.Xavier(), ctx=_ctx(mx))
    return net


def _lm(mx, seed=3):
    mod = __import__(f"{mx.__name__}.gluon.model_zoo.transformer",
                     fromlist=["TransformerLM"])
    mx.random.seed(seed)
    net = mod.TransformerLM(vocab=32, dim=32, num_layers=2, num_heads=4,
                            max_len=16, attn_type="flash")
    net.initialize(mx.init.Xavier(), ctx=_ctx(mx))
    net.hybridize()
    return net


def _data(kind, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "mlp":
        return rs.normal(0, 1, (8, 16)).astype("f"), \
            rs.normal(0, 1, (8, 1)).astype("f")
    if kind == "cnn":
        return rs.normal(0, 1, (8, 3, 8, 8)).astype("f"), \
            rs.randint(0, 3, (8,)).astype("f")
    toks = rs.randint(0, 32, (2, 17))
    return toks[:, :-1].astype("f"), toks[:, 1:].astype("f")


_NETS = {"mlp": _mlp, "cnn": _cnn, "lm": _lm}


def _loss(mx, kind):
    return mx.gluon.loss.L2Loss() if kind == "mlp" else \
        mx.gluon.loss.SoftmaxCrossEntropyLoss()


def _trainer(mx, net, comp=None, opt="sgd", opt_params=None,
             update_on_kvstore=False):
    return mx.gluon.Trainer(
        net.collect_params(), opt,
        dict(opt_params or {"learning_rate": 0.05, "momentum": 0.9}),
        kvstore="tpu_sync", update_on_kvstore=update_on_kvstore,
        compression_params=comp)


def _np(t):
    return t.asnumpy() if hasattr(t, "asnumpy") else \
        t.detach().float().cpu().numpy()


def _port_net(kind, jnet=None, x=None):
    """The port's net of ``kind``, with the JAX net's weights if given."""
    net = _NETS[kind](mxt)
    if jnet is not None:
        try:
            [p.data() for p in jnet.collect_params().values()]
        except mxj.gluon.parameter.DeferredInitializationError:
            jnet(_array(mxj, x))        # shapes deferred to a forward
        params_from_mxnet_tpu({n: p.data().asnumpy() for n, p in
                               jnet.collect_params().items()}, net)
    return net


def _run(mx, monkeypatch, net, kind, steps=5, whole=True, comp=None,
         opt="sgd", opt_params=None, amp=None):
    """Losses per step and the weights after ``steps`` steps through the
    package's WholeStepCompiler (the fused path when ``whole`` is off)."""
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1" if whole else "0")
    if amp:
        monkeypatch.setenv("MXNET_AMP", amp)
    x, y = _data(kind)
    tr = _trainer(mx, net, comp, opt, opt_params)
    cls = WholeStepCompiler if mx is mxt else JaxWholeStep
    st = cls(net, _loss(mx, kind), tr)
    xs, ys = _array(mx, x), _array(mx, y)
    losses = [_np(st.step(xs, ys)) for _ in range(steps)]
    return losses, [_np(p.data()) for p in net.collect_params().values()], \
        tr, st


# -- policy ------------------------------------------------------------------
@pytest.mark.parametrize("raw", ["", "0", "off", "F32", "fp32", "bf16",
                                 "bfloat16", "fp16", "f16", "float16",
                                 "int8"])
def test_amp_policy_parses_as_jax(monkeypatch, raw):
    monkeypatch.setenv("MXNET_AMP", raw)
    try:
        want = jax_amp_policy()
    except mxj.base.MXNetError:
        with pytest.raises(mxt.base.MXNetError, match="not understood"):
            amp_policy()
        return
    assert amp_policy() == want


# -- the whole step against the port's fused path -----------------------------
@pytest.mark.parametrize("kind,opt,opt_params,comp", [
    ("mlp", "sgd", None, None),
    ("mlp", "adam", {"learning_rate": 3e-3}, None),
    ("mlp", "sgd", None, {"type": "2bit", "threshold": 0.5}),
    ("cnn", "adam", {"learning_rate": 3e-3}, None),
], ids=["sgd", "adam", "compressed", "batchnorm-adam"])
def test_whole_step_bitwise_matches_fused_path(monkeypatch, kind, opt,
                                               opt_params, comp):
    lw, ww, trw, st = _run(mxt, monkeypatch, _NETS[kind](mxt), kind,
                           comp=comp, opt=opt, opt_params=opt_params)
    assert st.active, st.fallback_reason
    lf, wf, trf, _ = _run(mxt, monkeypatch, _NETS[kind](mxt), kind,
                          whole=False, comp=comp, opt=opt,
                          opt_params=opt_params)
    for a, b in zip(lw + ww, lf + wf):
        np.testing.assert_array_equal(a, b)
    if comp:
        for a, b in zip(trw._residuals, trf._residuals):
            assert torch.equal(a, b)


# -- the whole step against the JAX package -----------------------------------
@pytest.mark.parametrize("kind,amp,tol", [
    ("lm", None, 1e-5), ("cnn", None, 1e-5), ("mlp", "bf16", BF16_TOL),
], ids=["f32-lm", "f32-batchnorm", "bf16"])
def test_whole_step_matches_jax(monkeypatch, kind, amp, tol):
    """The JAX package's TransformerLM falls back to its fused path (its
    whole step refuses ``_contrib_arange_like``); the trajectory is the
    same in float32 either way.  fp16 is held in the scaler's test."""
    x, _ = _data(kind)
    jnet = _NETS[kind](mxj)
    tnet = _port_net(kind, jnet, x)
    opt_params = {"learning_rate": 0.05, "momentum": 0.9}
    # the LM's JAX run is its fused path, whose compiles take most of
    # this file's time: one step
    steps = 6 if amp else 1 if kind == "lm" else 5
    lj, wj, trj, _ = _run(mxj, monkeypatch, jnet, kind, steps, amp=amp,
                          opt_params=opt_params)
    lt, wt, trt, st = _run(mxt, monkeypatch, tnet, kind, steps, amp=amp,
                           opt_params=opt_params)
    assert st.active, st.fallback_reason
    for a, b in zip(lt + wt, lj + wj):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    assert all(w.dtype == np.float32 for w in wt)
    assert trt.loss_scale == trj.loss_scale


def test_fp16_scale_growth_backoff_and_skip_match_jax(monkeypatch):
    """Window 3 from 1024: the scale after each of 5 finite steps, an inf
    batch and a finite step is the JAX run's, and the weights after them
    are within 0.05 (the reference's fp16 tolerance) of the JAX run's;
    the skipped step holds the weights and the optimizer states bitwise,
    and the next one trains."""
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    monkeypatch.setenv("MXNET_AMP", "fp16")
    monkeypatch.setenv("MXNET_LOSS_SCALE_INIT", "1024")
    monkeypatch.setenv("MXNET_LOSS_SCALE_WINDOW", "3")
    kind = "mlp"
    x, y = _data(kind)
    bad = np.full_like(x, np.inf)
    jnet = _NETS[kind](mxj)
    nets = {mxj: jnet, mxt: _port_net(kind, jnet, x)}
    scales = {}
    for mx, net in nets.items():
        tr = _trainer(mx, net)
        cls = WholeStepCompiler if mx is mxt else JaxWholeStep
        st = cls(net, _loss(mx, kind), tr)
        seq = []
        for i, xb in enumerate([x] * 5 + [bad, x]):
            if mx is mxt and i == 5:
                keep = [p.data().clone() for p in tr._params] + \
                    [t.clone() for s in tr._updater.states.values()
                     for t in (s if isinstance(s, tuple) else (s,))]
            st.step(_array(mx, xb), _array(mx, y))
            seq.append(tr.loss_scale)
            if mx is mxt and i == 5:
                after = [p.data().clone() for p in tr._params] + \
                    [t.clone() for s in tr._updater.states.values()
                     for t in (s if isinstance(s, tuple) else (s,))]
                assert all(torch.equal(a, b) for a, b in zip(keep, after))
        if mx is mxt:
            assert st.active
            assert any(not torch.equal(a, p.data())
                       for a, p in zip(after, tr._params))
        scales[mx] = seq
    assert scales[mxt] == scales[mxj]
    for a, b in zip(nets[mxt].collect_params().values(),
                    nets[mxj].collect_params().values()):
        np.testing.assert_allclose(_np(a.data()), b.data().asnumpy(),
                                   rtol=FP16_TOL, atol=FP16_TOL)
    assert scales[mxt][2] == 2048.0 and scales[mxt][5] == 1024.0


def test_fp16_skip_step_holds_batchnorm_statistics(monkeypatch):
    """A batch with one nan skips its step: BatchNorm's moving statistics
    keep their values bitwise and the scale halves (1024 to 512, as in
    ``tests/test_wholestep.py:202-227``)."""
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    monkeypatch.setenv("MXNET_AMP", "fp16")
    monkeypatch.setenv("MXNET_LOSS_SCALE_INIT", "1024")
    net = _cnn(mxt)
    x, y = _data("cnn")
    xs, ys = _array(mxt, x), _array(mxt, y)
    net(xs)
    tr = _trainer(mxt, net)
    st = WholeStepCompiler(net, _loss(mxt, "cnn"), tr)
    st.step(xs, ys)
    assert st.active, st.fallback_reason
    stats = {n: p.data().clone() for n, p in net.collect_params().items()
             if "running" in n}
    assert stats
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    st.step(_array(mxt, bad), ys)
    assert tr.loss_scale == 512.0
    for n, before in stats.items():
        assert torch.equal(before, net.collect_params()[n].data())


@pytest.mark.parametrize("case", ["bucket residuals and scaler",
                                  "per-key residuals"])
def test_jax_state_file_resumes_in_the_port(monkeypatch, tmp_path, case):
    """A JAX trainer's ``save_states`` after 3 steps, with fp16 whole steps
    and compressed buckets (its wrapper carries ``bucket`` and ``scaler``),
    or with compression on a store that updates (``kv_residuals``); the
    port loads it over the same weights, and both take 3 more steps."""
    fp16 = case.startswith("bucket")
    comp = {"type": "2bit", "threshold": 0.05}
    if fp16:
        monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
        monkeypatch.setenv("MXNET_AMP", "fp16")
        monkeypatch.setenv("MXNET_LOSS_SCALE_INIT", "1024")
        monkeypatch.setenv("MXNET_LOSS_SCALE_WINDOW", "2")
    x, y = _data("mlp")
    jnet = _mlp(mxj)
    jtr = _trainer(mxj, jnet, comp, update_on_kvstore=not fp16)
    jst = JaxWholeStep(jnet, _loss(mxj, "mlp"), jtr)
    for _ in range(3):
        jst.step(_array(mxj, x), _array(mxj, y))
    fname = str(tmp_path / "t.states")
    jtr.save_states(fname)
    tnet = _port_net("mlp", jnet, x)
    ttr = _trainer(mxt, tnet, comp, update_on_kvstore=not fp16)
    tst = WholeStepCompiler(tnet, _loss(mxt, "mlp"), ttr)
    if fp16:
        tst._ensure_built()          # the bucketer, as after a first step
    ttr.load_states(fname)
    assert ttr.loss_scale == jtr.loss_scale
    if fp16:
        assert ttr.loss_scale == 2048.0 and ttr._residuals is not None
        np.testing.assert_array_equal(ttr._residuals[0].numpy(),
                                      np.asarray(jtr._residuals[0]))
    else:
        assert set(ttr._kv._residuals) == set(jtr._kv._residuals)
    x2 = x[::-1].copy()
    for mx, st in ((mxj, jst), (mxt, tst)):
        for _ in range(3):
            st.step(_array(mx, x2), _array(mx, y))
    tol = FP16_TOL if fp16 else 1e-5
    for a, b in zip(tnet.collect_params().values(),
                    jnet.collect_params().values()):
        np.testing.assert_allclose(_np(a.data()), b.data().asnumpy(),
                                   rtol=tol, atol=tol)
    assert ttr.loss_scale == jtr.loss_scale


# -- Module's MXNET_FUSED_STEP ------------------------------------------------
def _module(mx, kv="tpu_sync", optimizer="sgd", comp=None):
    net = mx.sym.Variable("data")
    net = mx.sym.Activation(mx.sym.Convolution(
        net, num_filter=4, kernel=(3, 3), pad=(1, 1), name="c1"),
        act_type="relu")
    net = mx.sym.BatchNorm(net, name="bn")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Flatten(net), num_hidden=3, name="fc"), name="softmax")
    mx.random.seed(5)
    mod = mx.mod.Module(net, context=_ctx(mx), compression_params=comp)
    mod.bind(data_shapes=[("data", (16, 3, 8, 8))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(kvstore=kv, optimizer=optimizer,
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    return mod


def test_fused_step_eligibility_warning_and_trajectory(monkeypatch, caplog):
    """Eligible as the JAX Module is (a store that updates; none; not with
    compression, one warning); the fused Module's weights after an epoch
    (2 steps) within 1e-5 of the JAX fused Module's."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    rs = np.random.RandomState(0)
    x = rs.normal(0, 1, (32, 3, 8, 8)).astype("f")
    y = rs.randint(0, 3, 32).astype("f")
    for kv, comp in (("tpu_sync", None), (None, None),
                     ("tpu_sync", {"type": "2bit"})):
        elig = []
        for mx in (mxj, mxt):
            mod = _module(mx, kv=kv, comp=comp)
            with caplog.at_level(logging.WARNING):
                caplog.clear()
                elig.append(mod._fused_step_eligible())
                mod._fused_step_eligible()
            if not elig[-1]:
                assert sum("not eligible" in r.getMessage()
                           for r in caplog.records) == 1
        assert elig[0] == elig[1], (kv, comp)
    mods = {}
    for mx in (mxj, mxt):
        mod = _module(mx)
        mod.fit(mx.io.NDArrayIter(_array(mx, x), _array(mx, y), 16,
                                  label_name="softmax_label"), num_epoch=1)
        mods[mx] = mod
    assert mods[mxt]._fstep_graph is not None
    ja, jx = mods[mxj].get_params()
    ta, tx = mods[mxt].get_params()
    for k in list(ja) + list(jx):
        got = (ta if k in ta else tx)[k]
        want = (ja if k in ja else jx)[k]
        np.testing.assert_allclose(_np(got), want.asnumpy(), rtol=1e-5,
                                   atol=1e-5)


# -- the superstep ------------------------------------------------------------
def test_superstep_bitwise_matches_sequential_steps(monkeypatch):
    """K=4: 8 steps as 2 supersteps, BatchNorm net, Adam, 2-bit
    compression: losses, weights and residuals of 8 sequential whole
    steps, bitwise."""
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    rs = np.random.RandomState(1)
    xs = [_array(mxt, rs.normal(0, 1, (8, 3, 8, 8)).astype("f"))
          for _ in range(8)]
    ys = [_array(mxt, rs.randint(0, 3, (8,)).astype("f")) for _ in range(8)]
    out = {}
    for sup in (False, True):
        net = _cnn(mxt)
        tr = _trainer(mxt, net, {"type": "2bit", "threshold": 0.5},
                      "adam", {"learning_rate": 3e-3})
        st = SuperStepCompiler(net, _loss(mxt, "cnn"), tr, k=4)
        if sup:
            losses = torch.cat([st.superstep(xs[i:i + 4], ys[i:i + 4])
                                for i in (0, 4)])
        else:
            losses = torch.stack([st.step(x, y) for x, y in zip(xs, ys)])
        out[sup] = [losses] + [p.data() for p in tr._params] + \
            list(tr._residuals)
        assert st.active
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


def test_superstep_k_resolves_as_jax(monkeypatch, tmp_path):
    """``MXNET_SUPERSTEP_K`` > constructor > the persisted decision > 4."""
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path))
    net = _mlp(mxt)
    x, y = _data("mlp")
    st = SuperStepCompiler(net, _loss(mxt, "mlp"), _trainer(mxt, net))
    assert st.k == 4 and st.decision_signature is None
    st.superstep([_array(mxt, x)] * 2, [_array(mxt, y)] * 2)
    sig = st.decision_signature
    tdec.enable()
    try:
        tdec.reset_cache()
        tdec.store(sig, {"superstep_k": 6})
        assert st.k == 6
        st._k_arg = 3
        assert st.k == 3
        monkeypatch.setenv("MXNET_SUPERSTEP_K", "5")
        assert st.k == 5
    finally:
        tdec.disable()
        tdec.reset_cache()


# -- decisions ----------------------------------------------------------------
def test_decisions_store_load_and_signature_as_jax(monkeypatch, tmp_path,
                                                   caplog):
    """The signature hashes as the JAX package's; a record round-trips
    through its JSON file; a corrupt file warns and misses; with the gate
    off every knob is its default; the Trainer takes ``bucket_size_mb``
    only when ``MXNET_BUCKET_SIZE_MB`` is unset."""
    sig = (((4, 3), "float32"), ((4,), "bfloat16"))
    assert tdec.model_signature(sig) == jdec.model_signature(sig)
    assert tdec.model_signature(sig, ("x",)) == \
        jdec.model_signature(sig, ("x",))
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path))
    s = tdec.model_signature(sig)
    tdec.reset_cache()
    path = tdec.store(s, {"bucket_size_mb": 0.001}, {"trials": 3},
                      platform="card")
    with open(path) as f:
        rec = json.load(f)
    assert rec["knobs"] == {"bucket_size_mb": 0.001} and \
        rec["platform"] == "card"
    tdec.reset_cache()
    assert tdec.load(s, platform="card")["evidence"] == {"trials": 3}
    assert tdec.knob(s, "bucket_size_mb", 7, platform="card") == 7
    bad = tdec.decision_path("feed", platform="card")
    with open(bad, "w") as f:
        f.write("{not json")
    with caplog.at_level(logging.WARNING):
        assert tdec.load("feed", platform="card") is None
    assert any("corrupt" in r.getMessage() for r in caplog.records)
    # the trainer's bucket cap from a decision for its gradients
    net = mxt.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=CPU)
    tr = mxt.gluon.Trainer(net.collect_params(), "sgd")
    gsig = (((4, 3), "float32"), ((4,), "float32"))
    tdec.enable()
    try:
        tdec.store(tdec.model_signature(gsig), {"bucket_size_mb": 0.001})
        assert tr._ensure_bucketer(gsig, (0, 1)).cap == 1048
        monkeypatch.setenv("MXNET_BUCKET_SIZE_MB", "2")
        tr._bucketer = None
        assert tr._ensure_bucketer(gsig, (0, 1)).cap == 2 * 1024 * 1024
    finally:
        tdec.disable()
        tdec.reset_cache()


# -- the rest of the surface --------------------------------------------------
def test_step_overrides_replace_ops_and_skip_segments():
    """``GraphPlan.run(step_overrides=)`` calls the override in place of its
    step's op; with overrides a segmented run runs whole."""
    from mxnet_tpu_torch.symbol.graph import GraphPlan
    sym = mxt.sym.FullyConnected(mxt.sym.var("x"), num_hidden=3, name="fc")
    sym = mxt.sym.relu(sym)
    plan = GraphPlan(sym)
    rs = np.random.RandomState(0)
    args = {"x": torch.from_numpy(rs.randn(2, 4).astype("f")),
            "fc_weight": torch.from_numpy(rs.randn(3, 4).astype("f")),
            "fc_bias": torch.from_numpy(rs.randn(3).astype("f"))}
    (want,), _ = plan.run(args)
    seen = []

    def over(p, ins):
        seen.append(len(ins))
        return plan.steps[0].op.fn(p, *ins) * 2

    (got,), _ = plan.run(args, step_overrides={0: over}, segments=2)
    assert seen == [3]
    torch.testing.assert_close(got, want * 2, rtol=0, atol=0)


def test_ineligible_trainer_falls_back_with_one_warning(monkeypatch,
                                                        caplog):
    """A store that updates is not whole-step material: the fused path
    trains, one warning names the reason; MXNET_AMP without the whole step
    warns once too."""
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    net = _mlp(mxt)
    x, y = (_array(mxt, a) for a in _data("mlp"))
    tr = _trainer(mxt, net, update_on_kvstore=True)
    st = WholeStepCompiler(net, _loss(mxt, "mlp"), tr)
    with caplog.at_level(logging.WARNING):
        losses = [float(st.step(x, y).detach().mean()) for _ in range(3)]
    assert not st.active and "update_on_kvstore" in st.fallback_reason
    assert sum("not whole-step compilable" in r.getMessage()
               for r in caplog.records) == 1
    assert losses[-1] < losses[0]
    monkeypatch.setenv("MXNET_WHOLE_STEP", "0")
    monkeypatch.setenv("MXNET_AMP", "bf16")
    st = WholeStepCompiler(net, _loss(mxt, "mlp"), _trainer(mxt, net))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        st.step(x, y)
        st.step(x, y)
    assert sum("MXNET_WHOLE_STEP is not enabled" in r.getMessage()
               for r in caplog.records) == 1


def test_checkpoint_stamps_the_policy_that_ran(monkeypatch, tmp_path):
    """``save_trainer`` stamps "fp16" after fp16 whole steps, "f32" after a
    fused step; the scaler rides the trainer's state."""
    monkeypatch.setenv("MXNET_CHECKPOINT_FSYNC", "0")
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    monkeypatch.setenv("MXNET_AMP", "fp16")
    net = _mlp(mxt)
    x, y = (_array(mxt, a) for a in _data("mlp"))
    tr = _trainer(mxt, net)
    st = WholeStepCompiler(net, _loss(mxt, "mlp"), tr)
    st.step(x, y)
    st.step(x, y)
    mgr = mxt.checkpoint.CheckpointManager(str(tmp_path / "a"))
    mxt.checkpoint.save_trainer(mgr, 2, net.collect_params(), tr,
                                block=True)
    mgr.close()
    stamps = []
    for d in sorted(os.listdir(tmp_path / "a")):
        mpath = os.path.join(tmp_path, "a", d, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                stamps.append(json.load(f)["signatures"]["amp_policy"])
    assert stamps == ["fp16"]
    monkeypatch.setenv("MXNET_WHOLE_STEP", "0")
    st.step(x, y)
    assert tr._updater.dtype_policy == "f32"


def test_capture_failure_names_the_op_and_recapture_says_why(monkeypatch):
    """A step that fails while it is captured raises ``MXNetError`` naming
    the op at fault (nothing is retried eagerly); a capture under a new
    key says which fields moved."""
    from mxnet_tpu_torch.gluon.wholestep import StepGraph

    class Graph:
        def register_generator_state(self, gen):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    sg = StepGraph("whole-step",
                   lambda: "the forward, node 'fc1' (op FullyConnected)")

    def step():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(mxt.base.MXNetError, match="node 'fc1'"):
        sg._capture(step, [])
    sg._last = (("data", ((8, 16),)), ("amp policy", "f32"))
    assert sg._why((("data", ((4, 16),)), ("amp policy", "f32"))) == \
        "data ((8, 16),) -> ((4, 16),)"
