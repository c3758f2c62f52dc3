"""The port's optimizers, updaters and optimizer-state files against the
JAX package's, on the CPU.

The same seeded numpy weights and gradients go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` (``ctx=cpu()``) for five steps.  The port is held to
the JAX package's per-key ``Updater``, which the JAX ``FusedUpdater``
matches only to 8.8e-7 for Adam (it computes the bias correction in
float32): every parameter and state within 1e-6 of its largest magnitude
in float32; under bfloat16 ``multi_precision`` the float32 masters within
1e-6 and the weights within one bfloat16 ulp.  The port's
``FusedUpdater`` equals its per-key ``Updater`` bitwise, as do its own
state files after a round trip.  Files written by the JAX package
(``Trainer.save_states``, ``Module.save_optimizer_states``) load into the
port, which then continues three steps within the same tolerances as the
JAX package's own continuation.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError

CPU = mxt.cpu()
SHAPES = [(6, 4), (4,), (3, 5)]
STEPS = 5
TOL = 1e-6

# (name, kwargs): every registered optimizer, RMSProp centered too
CASES = [("sgd", dict(momentum=0.9, wd=1e-3)), ("sgd", {}),
         ("ccsgd", dict(momentum=0.5, clip_gradient=0.4)),
         ("nag", dict(momentum=0.9, wd=1e-3)),
         ("adam", dict(wd=1e-3, clip_gradient=0.5)),
         ("rmsprop", dict(wd=1e-3)),
         ("rmsprop", dict(centered=True, clip_weights=2.0)),
         ("adagrad", dict(wd=1e-3)), ("adadelta", dict(wd=1e-3)),
         ("ftrl", dict(wd=1e-3)), ("adamax", dict(wd=1e-3)),
         ("nadam", dict(wd=1e-3)), ("dcasgd", dict(momentum=0.9, wd=1e-3)),
         ("test", {})]
IDS = [f"{n}-{'-'.join(sorted(kw)) or 'plain'}" for n, kw in CASES]
FUSED = [(n, kw) for n, kw in CASES if n in (
    "sgd", "ccsgd", "nag", "adam", "rmsprop", "adagrad", "adadelta", "ftrl",
    "adamax")]


def _to_np(x):
    if isinstance(x, np.ndarray):
        return x.astype("f")
    if hasattr(x, "asnumpy"):
        return x.asnumpy().astype("f")
    return mxt.nd.asnumpy(x.float())


def _flat(state):
    """A state's arrays, in order, without its Nones."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _data(seed=0):
    rs = np.random.RandomState(seed)
    w0 = [rs.randn(*s).astype("f") for s in SHAPES]
    grads = [[rs.randn(*s).astype("f") for s in SHAPES]
             for _ in range(STEPS)]
    return w0, grads


def _make(mx, name, kw, **extra):
    return mx.optimizer.create(name, learning_rate=0.05, rescale_grad=0.5,
                               **kw, **extra)


def _run_jax(name, kw, dtype="float32", **extra):
    w0, grads = _data()
    upd = mxj.optimizer.Updater(_make(mxj, name, kw, **extra))
    ws = [mxj.nd.array(w).astype(dtype) for w in w0]
    for step in grads:
        for i, g in enumerate(step):
            upd(i, mxj.nd.array(g).astype(dtype), ws[i])
    return ws, upd


def _run_port(name, kw, dtype="float32", fused=True, **extra):
    w0, grads = _data()
    opt = _make(mxt, name, kw, **extra)
    upd = mxt.optimizer.get_updater(opt) if fused \
        else mxt.optimizer.Updater(opt)
    ws = [mxt.nd.array(w, ctx=CPU, dtype=dtype) for w in w0]
    for step in grads:
        gs = [mxt.nd.array(g, ctx=CPU, dtype=dtype) for g in step]
        if fused:
            upd.update_all(list(range(len(ws))), gs, ws)
        else:
            for i, (g, w) in enumerate(zip(gs, ws)):
                upd(i, g, w)
    return ws, upd


def _assert_close(got, want, tol=TOL, what=""):
    got, want = _to_np(got), _to_np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of its largest (limit {tol})"


def test_every_jax_optimizer_is_registered_and_the_updater_is_fused():
    names = {n.lower() for n in mxj.optimizer._REG.list()}
    assert names == set(mxt.optimizer._REG.list())
    assert len(names) == 13
    opt = mxt.optimizer.create("adam")
    assert isinstance(mxt.optimizer.get_updater(opt),
                      mxt.optimizer.FusedUpdater)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_optimizer_matches_jax_float32(name, kw):
    jw, jupd = _run_jax(name, kw)
    tw, tupd = _run_port(name, kw)
    for i, (t, j) in enumerate(zip(tw, jw)):
        _assert_close(t, j, what=f"{name} weight {i}")
        js, ts = _flat(jupd.states[i]), _flat(tupd.states[i])
        assert len(js) == len(ts)
        for k, (a, b) in enumerate(zip(ts, js)):
            _assert_close(a, b, what=f"{name} state {i}.{k}")


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_optimizer_matches_jax_bf16_multi_precision(name, kw):
    jw, jupd = _run_jax(name, kw, "bfloat16", multi_precision=True)
    tw, tupd = _run_port(name, kw, "bfloat16", multi_precision=True)
    for i, (t, j) in enumerate(zip(tw, jw)):
        jm, tm = jupd.states[i][1], tupd.states[i][1]
        _assert_close(tm, jm, what=f"{name} master {i}")
        # one bfloat16 ulp at each weight's magnitude
        got, want = _to_np(t), _to_np(j)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert np.all(np.abs(got - want) <= ulp), f"{name} weight {i}"


_NEW_OPS = [
    ("rmsprop_update", ["n"], dict(lr=0.05, wd=0.01, gamma1=0.9,
                                   clip_weights=1.5, rescale_grad=0.5)),
    ("rmspropalex_update", ["n", "g", "delta"],
     dict(lr=0.05, wd=0.01, gamma1=0.9, gamma2=0.8, clip_gradient=0.7)),
    ("ftrl_update", ["z", "n"], dict(lr=0.1, wd=0.01, lamda1=0.05,
                                     beta=1.0, rescale_grad=0.5))]


@pytest.mark.parametrize("op,states,kw", _NEW_OPS,
                         ids=[u[0] for u in _NEW_OPS])
def test_new_update_op_matches_jax(op, states, kw):
    rs = np.random.RandomState(3)
    weight, grad = rs.randn(2, 5, 3).astype("f")
    init = {"n": rs.rand(5, 3).astype("f") + 0.5,
            "g": 0.1 * rs.randn(5, 3).astype("f"),
            "delta": rs.randn(5, 3).astype("f"),
            "z": rs.randn(5, 3).astype("f")}
    jargs = [mxj.nd.array(a) for a in [weight, grad]
             + [init[s] for s in states]]
    targs = [mxt.nd.array(a, ctx=CPU) for a in [weight, grad]
             + [init[s] for s in states]]
    getattr(mxj.nd, op)(*jargs, **kw)
    out = getattr(mxt.nd, op)(*targs, **kw)
    assert out is targs[0]              # the weight, written in place
    for t, j in zip(targs, jargs):
        np.testing.assert_allclose(_to_np(t), _to_np(j), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", FUSED,
                         ids=[i for (n, k), i in zip(CASES, IDS)
                              if (n, k) in FUSED])
def test_fused_updater_equals_the_per_key_updater_bitwise(name, kw, dtype):
    mp = dict(multi_precision=True) if dtype == "bfloat16" else {}
    fw, fupd = _run_port(name, kw, dtype, fused=True, **mp)
    kw_, kupd = _run_port(name, kw, dtype, fused=False, **mp)
    for i, (a, b) in enumerate(zip(fw, kw_)):
        assert torch.equal(a, b), f"{name} weight {i}"
        for x, y in zip(_flat(fupd.states[i]), _flat(kupd.states[i])):
            assert torch.equal(x, y), f"{name} state {i}"
    assert fupd.optimizer._index_update_count == \
        kupd.optimizer._index_update_count == {0: 5, 1: 5, 2: 5}


def test_sgld_repeats_under_a_seed_and_draws_its_noise():
    """SGLD's noise is random: the same seed repeats a step bitwise, and
    the step minus its gradient part has the noise's spread, sqrt(lr)."""
    lr = 0.01
    rs = np.random.RandomState(0)
    w0, g = rs.randn(2, 200, 100).astype("f")
    outs = []
    for _ in range(2):
        mxt.random.seed(7)
        opt = mxt.optimizer.create("sgld", learning_rate=lr)
        w = mxt.nd.array(w0, ctx=CPU)
        mxt.optimizer.get_updater(opt).update_all(
            [0], [mxt.nd.array(g, ctx=CPU)], [w])
        outs.append(w)
    assert torch.equal(outs[0], outs[1])
    noise = _to_np(outs[0]) - (w0 - lr / 2 * g)
    assert abs(noise.mean()) < 3e-3
    assert abs(noise.std() / np.sqrt(lr) - 1) < 2e-2


# -- state files ------------------------------------------------------------
def _dense_pair(seed=0):
    """One Dense layer in each package with the same weights."""
    rs = np.random.RandomState(seed)
    w, b = rs.randn(3, 4).astype("f"), rs.randn(3).astype("f")
    nets = {}
    for mx, ctx in ((mxj, mxj.cpu()), (mxt, CPU)):
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=ctx)
        net.weight.set_data(mx.nd.array(w, ctx=ctx))
        net.bias.set_data(mx.nd.array(b, ctx=ctx))
        nets[mx] = net
    return nets


def _train(mx, net, trainer, steps, seed):
    ctx = mxj.cpu() if mx is mxj else CPU
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        x = mx.nd.array(rs.randn(5, 4).astype("f"), ctx=ctx)
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(5)


def _weights(net):
    return [_to_np(p.data()) for p in net.collect_params().values()]


_STATE_CASES = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
                ("adam", {"learning_rate": 0.01,
                          "lr_scheduler": "factor"})]


def _opt_params(mx, params):
    params = dict(params)
    if params.get("lr_scheduler") == "factor":
        params["lr_scheduler"] = mx.lr_scheduler.FactorScheduler(2, 0.5)
    return params


@pytest.mark.parametrize("name,params", _STATE_CASES,
                         ids=[c[0] for c in _STATE_CASES])
def test_jax_trainer_states_resume_in_the_port(name, params, tmp_path):
    """Two JAX steps, ``save_states``; the port loads the file into a
    trainer over the same weights and takes three more steps beside the
    JAX trainer's own three."""
    nets = _dense_pair()
    jt = mxj.gluon.Trainer(nets[mxj].collect_params(), name,
                           _opt_params(mxj, params))
    _train(mxj, nets[mxj], jt, 2, seed=1)
    fname = str(tmp_path / "t.states")
    jt.save_states(fname)
    for p, q in zip(nets[mxt].collect_params().values(),
                    nets[mxj].collect_params().values()):
        p.set_data(mxt.nd.array(q.data().asnumpy(), ctx=CPU))
    tt = mxt.gluon.Trainer(nets[mxt].collect_params(), name,
                           _opt_params(mxt, params))
    tt.load_states(fname)
    assert tt._optimizer.param_dict[0] is \
        list(nets[mxt].collect_params().values())[0]
    assert tt._optimizer._index_update_count == {0: 2, 1: 2}
    _train(mxj, nets[mxj], jt, 3, seed=2)
    _train(mxt, nets[mxt], tt, 3, seed=2)
    for got, want in zip(_weights(nets[mxt]), _weights(nets[mxj])):
        _assert_close(got, want, tol=1e-5, what=name)


def test_jax_module_states_resume_in_the_port(tmp_path):
    """A JAX Module's ``save_optimizer_states`` file (SGD momentum, keyed
    by parameter index) continues in the port's Module."""
    rs = np.random.RandomState(0)
    x = rs.randn(16, 6).astype("f")
    y = rs.randint(0, 3, 16).astype("f")
    mods, fname = {}, str(tmp_path / "m.states")
    for mx, ctx in ((mxj, mxj.cpu()), (mxt, CPU)):
        data = mx.sym.var("data")
        fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
        mod = mx.mod.Module(mx.sym.SoftmaxOutput(fc, name="softmax"),
                            context=ctx)
        mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
        mx.random.seed(0)
        mod.init_params(mx.init.Xavier())
        mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params=(
            ("learning_rate", 0.1), ("momentum", 0.9)))
        mods[mx] = mod
    it = mxj.io.NDArrayIter(x, y, batch_size=8)
    for batch in it:
        mods[mxj].forward_backward(batch)
        mods[mxj].update()
    mods[mxj].save_optimizer_states(fname)
    args, auxs = mods[mxj].get_params()
    mods[mxt].set_params({k: mxt.nd.array(v.asnumpy(), ctx=CPU)
                          for k, v in args.items()}, {})
    mods[mxt].load_optimizer_states(fname)
    for mx, m in mods.items():
        it = mx.io.NDArrayIter(x[::-1].copy(), y, batch_size=8)
        for batch in it:
            m.forward_backward(batch)
            m.update()
    targs, _ = mods[mxt].get_params()
    jargs, _ = mods[mxj].get_params()
    for k in jargs:
        _assert_close(targs[k], jargs[k], tol=1e-5, what=k)


def test_port_states_round_trip_bitwise(tmp_path):
    """bf16 Adam with float32 masters: ``save_states`` then
    ``load_states`` into a fresh trainer over a copy of the weights; both
    take two more steps and stay bitwise equal."""
    nets = []
    for _ in range(2):
        mxt.random.seed(0)
        net = mxt.gluon.nn.Dense(3, in_units=4)
        net.initialize(mxt.init.Xavier(), ctx=CPU)
        net.cast("bfloat16")
        nets.append(net)
    params = {"learning_rate": 0.01, "multi_precision": True}
    t0 = mxt.gluon.Trainer(nets[0].collect_params(), "adam", params)

    def train(net, trainer, steps, seed):
        rs = np.random.RandomState(seed)
        for _ in range(steps):
            x = mxt.nd.array(rs.randn(5, 4), ctx=CPU, dtype="bfloat16")
            with mxt.autograd.record():
                loss = (net(x).float() ** 2).sum()
            loss.backward()
            trainer.step(5)

    train(nets[0], t0, 2, 1)
    fname = str(tmp_path / "p.states")
    t0.save_states(fname)
    for p, q in zip(nets[1].collect_params().values(),
                    nets[0].collect_params().values()):
        p.set_data(q.data())
    t1 = mxt.gluon.Trainer(nets[1].collect_params(), "adam", params)
    t1.load_states(fname)
    assert not any(t1._updater.states_synced.values())
    for net, tr in zip(nets, (t0, t1)):
        train(net, tr, 2, 2)
    for a, b in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        assert torch.equal(a.data(), b.data())
    for i in t0._updater.states:
        for x, y in zip(_flat(t0._updater.states[i]),
                        _flat(t1._updater.states[i])):
            assert torch.equal(x, y)
    # arrays go in as numpy through _rebuild_ndarray: no torch storage,
    # no ml_dtypes
    with open(fname, "rb") as f:
        text = f.read()
    assert b"_rebuild_ndarray" in text
    for word in (b"torch._utils", b"_rebuild_tensor", b"ml_dtypes"):
        assert word not in text


def test_jax_bf16_states_raise_naming_the_dtype():
    """bfloat16 states pickled by the JAX package need ml_dtypes: the port
    refuses the file with ``MXNetError`` and keeps its own states."""
    opt = mxj.optimizer.create("sgd", momentum=0.9)
    upd = mxj.optimizer.Updater(opt)
    w = mxj.nd.array(np.ones((2, 3), "f")).astype("bfloat16")
    upd(0, mxj.nd.array(np.ones((2, 3), "f")).astype("bfloat16"), w)
    payload = upd.get_states()
    tupd = mxt.optimizer.get_updater(mxt.optimizer.create("sgd"))
    tupd.states = {5: None}
    with pytest.raises(MXNetError, match="bfloat16"):
        tupd.set_states(payload)
    assert tupd.states == {5: None}


def test_state_files_load_only_allowed_classes():
    """A state file that names anything but the port's classes, numpy or
    plain builtins raises before it is used."""
    class Evil:
        def __reduce__(self):
            return (print, ("never",))
    upd = mxt.optimizer.get_updater(mxt.optimizer.create("sgd"))
    with pytest.raises(MXNetError, match="builtins.print"):
        upd.set_states(pickle.dumps({0: Evil()}))


def test_fused_trainer_switch_pins_the_per_key_path(monkeypatch):
    """``MXNET_FUSED_TRAINER=0`` steps through the per-key ``__call__``;
    the default makes one ``update_all`` per step and no per-key call; the
    weights agree bitwise."""
    calls = {"update_all": 0, "call": 0}
    real_all = mxt.optimizer.FusedUpdater.update_all
    real_call = mxt.optimizer.Updater.__call__

    def count_all(self, *a, **k):
        calls["update_all"] += 1
        return real_all(self, *a, **k)

    def count_call(self, *a, **k):
        calls["call"] += 1
        return real_call(self, *a, **k)

    monkeypatch.setattr(mxt.optimizer.FusedUpdater, "update_all", count_all)
    monkeypatch.setattr(mxt.optimizer.Updater, "__call__", count_call)
    weights, seen = [], []
    for env in ("1", "0"):
        monkeypatch.setenv("MXNET_FUSED_TRAINER", env)
        net = _dense_pair()[mxt]
        trainer = mxt.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01})
        calls.update(update_all=0, call=0)
        _train(mxt, net, trainer, 3, seed=4)
        seen.append(dict(calls))
        weights.append(_weights(net))
    assert seen == [{"update_all": 3, "call": 0},
                    {"update_all": 0, "call": 6}]
    for a, b in zip(*weights):
        np.testing.assert_array_equal(a, b)
