"""The port's TrainingSupervisor against its own uninterrupted runs and
against the JAX package's supervisor, on the CPU.

The same f32 MLP (weights carried from the JAX package by the port's
converter) trains through both supervisors with one injected transient;
the port's retried run is bitwise its uninterrupted run, and within 1e-5
of each weight's largest value of the JAX supervisor's retried run.
Divergence (``raise`` and ``rewind``) acts at the same step in both
packages, a delayed step raises ``TrainingStalledError`` in both, a
restore writes the snapshot back into the live tensors (no new storage),
and ``Module.fit(supervise=True)`` equals ``fit()``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import faultinject as jfi
from mxnet_tpu import resilience as jres
from mxnet_tpu.gluon import supervisor as jsup
from mxnet_tpu_torch import faultinject as tfi
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import supervisor as tsup
from mxnet_tpu_torch.observability import metrics as TM

CPU = mxt.cpu()
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Unlimited post-mortems, dumps in scratch, no fault plan, the
    supervisors on, one intra-op thread (bitwise comparisons)."""
    for res in (jres, tres):
        monkeypatch.setattr(res, "POST_MORTEM_MIN_S", 0.0)
        res.reset()
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path / "fl"))
    prev = (jfi.install(None), tfi.install(None))
    jsup.enable()
    tsup.enable()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jfi.install(prev[0])
    tfi.install(prev[1])
    torch.set_num_threads(threads)


def _ctx(mx):
    return CPU if mx is mxt else mxj.cpu()


def _jax_weights():
    mxj.random.seed(0)
    net = mxj.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mxj.gluon.nn.Dense(16, activation="relu", in_units=16))
        net.add(mxj.gluon.nn.Dense(1, in_units=16))
    net.initialize(mxj.init.Xavier())
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


_W = None


def _setup(mx, lr=0.05):
    global _W
    if _W is None:
        _W = _jax_weights()
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=16))
        net.add(mx.gluon.nn.Dense(1, in_units=16))
    net.initialize(mx.init.Xavier(), ctx=_ctx(mx))
    if mx is mxt:
        params_from_mxnet_tpu(_W, net)
    else:
        for (n, p), w in zip(net.collect_params().items(), _W.values()):
            p.set_data(mxj.nd.array(w))
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": lr, "momentum": 0.9},
                          kvstore="tpu_sync", update_on_kvstore=False)
    return net, tr


def _mkstep(mx, net, tr, bs=8):
    loss = mx.gluon.loss.L2Loss()

    def step(x, y):
        with mx.autograd.record():
            l = loss(net(x), y)
        l.backward()
        tr.step(bs)
        return l
    return step


def _data(mx, nan=False, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.normal(0, 1, (8, 16)).astype("f")
    if nan:
        x[0, 0] = np.nan
    y = rs.normal(0, 1, (8, 1)).astype("f")
    return mx.nd.array(x, ctx=_ctx(mx)), mx.nd.array(y, ctx=_ctx(mx))


def _weights(mx, net):
    return [np.asarray(mx.nd.asnumpy(p.data()) if mx is mxt
                       else p.data().asnumpy())
            for p in net.collect_params().values()]


def _pkg(mx):
    return (tfi, tres, tsup.TrainingSupervisor) if mx is mxt \
        else (jfi, jres, jsup.TrainingSupervisor)


def _retried_run(mx, steps=6, fault_at=3):
    fi, res, Sup = _pkg(mx)
    net, tr = _setup(mx)
    sup = Sup(_mkstep(mx, net, tr), trainer=tr, params=net,
              snapshot_steps=2)
    plan = fi.FaultPlan().add("trainer.step", "raise", exc=OSError,
                              times=1, after=fault_at)
    x, y = _data(mx)
    with fi.active(plan):
        for _ in range(steps):
            sup.step(x, y)
    assert plan.stats() == {"trainer.step": 1}
    sup.close()
    return net, sup


def test_retried_run_is_bitwise_the_uninterrupted_run_and_follows_jax():
    retries = TM.SUPERVISOR_RETRIES.value
    net, sup = _retried_run(mxt)
    assert TM.SUPERVISOR_RETRIES.value == retries + 1
    # the snapshot went back into the live tensors: nothing was dropped
    assert sup.last_restore == {"in_place": True, "why": None}
    ref_net, ref_tr = _setup(mxt)
    step = _mkstep(mxt, ref_net, ref_tr)
    x, y = _data(mxt)
    for _ in range(6):
        step(x, y)
    for a, b in zip(_weights(mxt, net), _weights(mxt, ref_net)):
        np.testing.assert_array_equal(a, b)
    jnet, _ = _retried_run(mxj)
    for a, b in zip(_weights(mxt, net), _weights(mxj, jnet)):
        assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("site,exc", [
    ("device.unavailable", None), ("kvstore.allreduce", OSError),
    ("memory.oom", None)])
def test_training_fault_sites_fire_on_the_path(site, exc):
    """Each training-path site fires once in a supervised step: the
    transient ones are retried to the uninterrupted run, bitwise; an
    out-of-memory one propagates typed."""
    net, tr = _setup(mxt)
    sup = tsup.TrainingSupervisor(_mkstep(mxt, net, tr), trainer=tr,
                                  params=net, snapshot_steps=2)
    kw = {"exc": exc} if exc is not None else {}
    plan = tfi.FaultPlan().add(site, "raise", times=1, after=2, **kw)
    x, y = _data(mxt)
    with tfi.active(plan):
        if site == "memory.oom":
            for _ in range(2):
                sup.step(x, y)
            with pytest.raises(mxt.observability.DeviceMemoryError):
                sup.step(x, y)
        else:
            for _ in range(4):
                sup.step(x, y)
    assert plan.stats() == {site: 1}
    sup.close()
    if site == "memory.oom":
        return
    ref, rtr = _setup(mxt)
    step = _mkstep(mxt, ref, rtr)
    for _ in range(4):
        step(x, y)
    for a, b in zip(_weights(mxt, net), _weights(mxt, ref)):
        np.testing.assert_array_equal(a, b)


def test_restore_writes_into_the_live_tensors():
    """The storage a captured step reads stays where it was."""
    net, tr = _setup(mxt)
    sup = tsup.TrainingSupervisor(_mkstep(mxt, net, tr), trainer=tr,
                                  params=net, snapshot_steps=1)
    x, y = _data(mxt)
    sup.step(x, y)
    sup.step(x, y)          # snapshot at step 1 holds the momentum
    ptrs = [p.data().data_ptr() for p in net.collect_params().values()]
    mom = [s.data_ptr() for s in tr._updater.states.values()]
    before = _weights(mxt, net)
    sup.step(x, y)
    sup._restore_snapshot()
    assert [p.data().data_ptr() for p in net.collect_params().values()] \
        == ptrs
    assert [s.data_ptr() for s in tr._updater.states.values()] == mom
    for a, b in zip(_weights(mxt, net), before):
        np.testing.assert_array_equal(a, b)
    assert sup.last_restore["in_place"]
    sup.close()


def test_restore_before_optimizer_states_existed_says_why():
    net, tr = _setup(mxt)
    sup = tsup.TrainingSupervisor(_mkstep(mxt, net, tr), trainer=tr,
                                  params=net, snapshot_steps=100)
    x, y = _data(mxt)
    sup.step(x, y)          # the snapshot predates the momentum states
    sup._restore_snapshot()
    assert not sup.last_restore["in_place"]
    assert "created after the snapshot" in sup.last_restore["why"]
    assert tr._updater.states == {}
    sup.close()


def _divergence(mx, on_diverge):
    fi, res, Sup = _pkg(mx)
    net, tr = _setup(mx)
    sup = Sup(_mkstep(mx, net, tr), trainer=tr, params=net,
              diverge_patience=2, on_diverge=on_diverge, snapshot_steps=2)
    x, y = _data(mx)
    xn, _ = _data(mx, nan=True)
    seen = []
    try:
        for i, xi in enumerate((x, x, xn, xn, x)):
            before = (TM if mx is mxt else
                      mxj.observability.metrics).SUPERVISOR_REWINDS.get(
                reason="divergence")
            sup.step(xi, y)
            after = (TM if mx is mxt else
                     mxj.observability.metrics).SUPERVISOR_REWINDS.get(
                reason="divergence")
            seen.append(after - before)
    except res.DivergenceError as e:
        seen.append(("raised", e.step, bool(e.report.get("report_path"))))
    sup.close()
    return seen, net


@pytest.mark.parametrize("on_diverge", ["raise", "rewind"])
def test_divergence_acts_at_the_same_step_as_jax(on_diverge):
    got, net = _divergence(mxt, on_diverge)
    want, jnet = _divergence(mxj, on_diverge)
    assert got == want
    if on_diverge == "raise":
        assert got[-1] == ("raised", 3, True)
    else:
        assert got == [0, 0, 0, 1, 0]
        # the rewind put back the step-2 snapshot; one more clean step
        # followed on both sides
        for a, b in zip(_weights(mxt, net), _weights(mxj, jnet)):
            assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-30)


def _stall(mx):
    fi, res, Sup = _pkg(mx)
    net, tr = _setup(mx)
    sup = Sup(_mkstep(mx, net, tr), trainer=tr, params=net,
              stall_min_s=0.2, stall_factor=2.0)
    x, y = _data(mx)
    for _ in range(6):      # warm the step EWMA past its warm-up
        sup.step(x, y)
    plan = fi.FaultPlan().add("trainer.step", "delay", delay_s=1.2, times=1)
    with fi.active(plan):
        with pytest.raises(res.TrainingStalledError) as ei:
            sup.step(x, y)
    with pytest.raises(res.TrainingStalledError, match="poisoned"):
        sup.step(x, y)
    return ei.value


def test_stall_raises_typed_in_both_packages():
    import time
    got = _stall(mxt)
    want = _stall(mxj)
    assert got.step == want.step == 6
    assert got.timeout_s >= 0.2 and want.timeout_s >= 0.2
    assert got.report["report_path"] and want.report["report_path"]
    time.sleep(1.3)   # the wedged workers finish their delayed steps


def test_first_step_transient_retries_from_a_capture_at_retry():
    net, tr = _setup(mxt)
    sup = tsup.TrainingSupervisor(_mkstep(mxt, net, tr), trainer=tr,
                                  params=net)
    plan = tfi.FaultPlan().add("trainer.step", "raise", exc=OSError,
                               times=1)
    x, y = _data(mxt)
    with tfi.active(plan):
        sup.step(x, y)
        sup.step(x, y)
    ref, rtr = _setup(mxt)
    step = _mkstep(mxt, ref, rtr)
    step(x, y)
    step(x, y)
    for a, b in zip(_weights(mxt, net), _weights(mxt, ref)):
        np.testing.assert_array_equal(a, b)
    sup.close()


def test_permanent_and_oom_errors_propagate_without_retry():
    net, tr = _setup(mxt)
    x, y = _data(mxt)
    sup = tsup.TrainingSupervisor(_mkstep(mxt, net, tr), trainer=tr,
                                  params=net)
    retries = TM.SUPERVISOR_RETRIES.value
    plan = tfi.FaultPlan().add("memory.oom", "raise", times=1)
    with tfi.active(plan):
        with pytest.raises(mxt.observability.DeviceMemoryError):
            sup.step(x, y)
    plan = tfi.FaultPlan().add("trainer.step", "raise",
                               exc=RuntimeError, times=1)
    with tfi.active(plan):
        with pytest.raises(RuntimeError):
            sup.step(x, y)
    assert TM.SUPERVISOR_RETRIES.value == retries
    sup.close()


def _fit(supervise, plan=None):
    rs = np.random.RandomState(0)
    X = rs.normal(0, 1, (32, 4)).astype("f")
    Y = (rs.rand(32) > 0.5).astype("f")
    mxt.random.seed(0)
    np.random.seed(0)
    data = mxt.sym.var("data")
    net = mxt.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mxt.sym.Activation(net, act_type="relu")
    net = mxt.sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = mxt.sym.SoftmaxOutput(net, name="softmax")
    mod = mxt.mod.Module(net, context=CPU)
    it = mxt.io.NDArrayIter(X, Y, batch_size=8)
    if plan is not None:
        with tfi.active(plan):
            mod.fit(it, num_epoch=2, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9},
                    supervise=supervise)
    else:
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                supervise=supervise)
    return mod.get_params()[0]


def test_module_fit_supervised_equals_fit():
    ref = _fit(False)
    plan = tfi.FaultPlan().add("trainer.step", "raise", exc=OSError,
                               times=1, after=3)
    got = _fit(True, plan=plan)
    assert plan.stats() == {"trainer.step": 1}
    for k in ref:
        np.testing.assert_array_equal(mxt.nd.asnumpy(ref[k]),
                                      mxt.nd.asnumpy(got[k]))


def test_supervisor_sections_in_snapshot():
    snap = mxt.observability.snapshot()
    for k in ("supervisor", "prefetch", "flight", "memory", "goodput",
              "journal", "analysis", "checkpoint"):
        assert k in snap
    assert set(snap["supervisor"]) >= {"snapshots", "retries", "rewinds",
                                       "watchdog_trips"}
