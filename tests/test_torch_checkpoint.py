"""The port's ``checkpoint/`` against the JAX package's, on the CPU.

Directories move between the packages both ways: one written by
``mxnet_tpu.checkpoint.save_trainer`` restores into a port net and
trainer, which then continue three steps within 1e-5 of the JAX
package's own continuation, and one written by the port reads back
through ``mxnet_tpu.checkpoint.layout.load_checkpoint_dir`` with equal
arrays.  The manager's contract: a torn write and a CRC mismatch (files
corrupted by hand) fall back to the previous step, retention keeps the
newest and the pinned steps, an async writer's error surfaces at
``wait``, the preemption hook saves once on its signal.  Its two
consumers: ``Module.fit(checkpoint_dir=...)`` stopped after one epoch
and resumed equals an uninterrupted fit bitwise, and
``BucketedPredictor.hot_reload`` swaps weights without building a
bucket.
"""
import os
import signal

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import checkpoint as jck
from mxnet_tpu_torch import checkpoint as ck
from mxnet_tpu_torch.base import MXNetError

CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _no_fsync(monkeypatch):
    # atomicity comes from the rename; fsync only slows the tests
    monkeypatch.setenv("MXNET_CHECKPOINT_FSYNC", "0")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else mxt.nd.asnumpy(x)


def _nets(seed=0):
    """A two-layer MLP in each package with the same weights."""
    rs = np.random.RandomState(seed)
    vals = [rs.randn(*s).astype("f") for s in ((8, 4), (8,), (3, 8), (3,))]
    nets = {}
    for mx, ctx in ((mxj, mxj.cpu()), (mxt, CPU)):
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(8, in_units=4, activation="relu"))
            net.add(mx.gluon.nn.Dense(3, in_units=8))
        net.initialize(ctx=ctx)
        for p, v in zip(net.collect_params().values(), vals):
            p.set_data(mx.nd.array(v, ctx=ctx))
        nets[mx] = net
    return nets


def _train(mx, net, trainer, steps, seed):
    ctx = mxj.cpu() if mx is mxj else CPU
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        x = mx.nd.array(rs.randn(6, 4).astype("f"), ctx=ctx)
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(6)


def _weights(net):
    return [_np(p.data()) for p in net.collect_params().values()]


def test_jax_checkpoint_dir_resumes_in_the_port(tmp_path):
    nets = _nets()
    opt = {"learning_rate": 0.01, "wd": 1e-3}
    jt = mxj.gluon.Trainer(nets[mxj].collect_params(), "adam", opt)
    _train(mxj, nets[mxj], jt, 2, seed=1)
    jmgr = jck.CheckpointManager(str(tmp_path), async_save=False)
    jck.save_trainer(jmgr, 2, nets[mxj], jt)
    fresh = _nets(seed=9)[mxt]          # other weights: the restore sets them
    tt = mxt.gluon.Trainer(fresh.collect_params(), "adam", opt)
    assert ck.restore_or_initialize(ck.CheckpointManager(str(tmp_path)),
                                    fresh, tt) == 2
    _train(mxj, nets[mxj], jt, 3, seed=2)
    _train(mxt, fresh, tt, 3, seed=2)
    for got, want in zip(_weights(fresh), _weights(nets[mxj])):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_port_checkpoint_dir_reads_back_in_jax(tmp_path):
    rs = np.random.RandomState(0)
    state = {"param:w": mxt.nd.array(rs.randn(3, 4), ctx=CPU),
             "h": np.arange(5, dtype=np.float16),
             "blob": b"\x00\x01opaque\xff", "meta": {"epoch": 3}}
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(4, state)
    mgr.wait()
    manifest, got = jck.load_checkpoint_dir(str(tmp_path / "step_4"))
    assert manifest["format_version"] == 1
    np.testing.assert_array_equal(got["param:w"], _np(state["param:w"]))
    np.testing.assert_array_equal(got["h"], state["h"])
    assert got["blob"] == state["blob"] and got["meta"] == state["meta"]
    assert jck.latest_step(str(tmp_path)) == 4


def test_bf16_entries_round_trip_without_ml_dtypes(tmp_path):
    """A bfloat16 tensor is stored as 2-byte raw data under the manifest
    dtype ``bfloat16`` and comes back as the same bits."""
    w = mxt.nd.array(np.random.RandomState(1).randn(4, 5), ctx=CPU,
                     dtype="bfloat16")
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": w})
    assert ck.read_manifest(str(tmp_path / "step_1"))["entries"]["w"][
        "dtype"] == "bfloat16"
    _, state = mgr.restore()
    assert torch.equal(mxt.nd.array(state["w"], ctx=CPU), w)


def _corrupt_torn(path):
    os.remove(os.path.join(path, "shard_0.npz"))


def _corrupt_crc(path):
    """Flip a byte mid-shard: the sizes stay, the CRC must catch it."""
    fp = os.path.join(path, "shard_0.npz")
    size = os.path.getsize(fp)
    with open(fp, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("corrupt", [_corrupt_torn, _corrupt_crc],
                         ids=["torn", "crc"])
def test_damaged_newest_step_falls_back(tmp_path, corrupt):
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    for step in (1, 2):
        mgr.save(step, {"w": np.full((64, 64), step, "f")})
    corrupt(str(tmp_path / "step_2"))
    step, state = mgr.restore()
    assert step == 1 and float(state["w"][0, 0]) == 1.0
    with pytest.raises(ck.CheckpointInvalidError):
        mgr.restore(step=2)
    corrupt(str(tmp_path / "step_1"))
    with pytest.raises(ck.CheckpointError, match="rejected every one"):
        mgr.restore()


def test_retention_keeps_the_newest_and_the_pinned(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), max_to_keep=2, keep_period=3)
    for step in range(1, 8):
        mgr.save(step, {"w": np.full(4, step, "f")})
    mgr.wait()
    assert mgr.all_steps() == [3, 5, 6, 7]
    os.makedirs(tmp_path / ".tmp-step_9-1-1")
    mgr.save(8, {"w": np.zeros(4, "f")})
    mgr.close()
    assert not (tmp_path / ".tmp-step_9-1-1").exists()
    assert mgr.all_steps() == [3, 6, 7, 8]


def test_async_writer_error_surfaces_at_wait(tmp_path):
    def fail(step, attempt):
        raise OSError(f"disk full at step {step}")

    mgr = ck.CheckpointManager(str(tmp_path), fault_hook=fail, retries=1,
                               backoff_s=0.0)
    mgr.save(1, {"w": np.zeros(3, "f")})      # returns: the write is queued
    with pytest.raises(ck.CheckpointError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []
    mgr.fault_hook = None
    mgr.save(2, {"w": np.zeros(3, "f")})
    mgr.close()
    assert mgr.all_steps() == [2]


def test_preemption_hook_saves_once_on_its_signal(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    calls = []

    def state_fn():
        calls.append(1)
        return 5, {"w": np.ones(3, "f")}

    uninstall = ck.install_preemption_hook(
        mgr, state_fn, signals=(signal.SIGUSR1,), use_atexit=False,
        exit_on_signal=False)
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        os.kill(os.getpid(), signal.SIGUSR1)     # at most once per install
    finally:
        uninstall()
    assert calls == [1]
    assert mgr.all_steps() == [5]
    assert ck.read_manifest(str(tmp_path / "step_5"))["meta"] == {
        "emergency": f"signal {int(signal.SIGUSR1)}"}
    assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL


def _mlp_module(mx):
    data = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=8,
                                                name="fc1"), act_type="relu")
    out = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.mod.Module(mx.sym.SoftmaxOutput(out, name="softmax"),
                         context=CPU)


@pytest.mark.parametrize("kvstore", [None, "tpu_sync"])
def test_module_fit_resumes_from_its_checkpoint_dir(tmp_path, kvstore):
    """``fit(checkpoint_dir=...)`` for one epoch, then a fresh Module's
    ``fit`` over two epochs there resumes at epoch 1: its parameters
    equal an uninterrupted two-epoch fit's bitwise, also where the
    optimizer runs on the store ("tpu_sync", ``bench.py``'s), which then
    steps the restored weights."""
    rs = np.random.RandomState(0)
    x = rs.randn(32, 6).astype("f")
    y = rs.randint(0, 3, 32).astype("f")
    kw = dict(optimizer="adam", optimizer_params=(("learning_rate", 0.01),),
              initializer=mxt.init.Xavier(), kvstore=kvstore)

    def fit(epochs, ckpt=None):
        mxt.random.seed(0)
        mod = _mlp_module(mxt)
        mod.fit(mxt.io.NDArrayIter(x, y, batch_size=8), num_epoch=epochs,
                checkpoint_dir=ckpt, **kw)
        return mod

    want = fit(2).get_params()[0]
    assert fit(0)._update_on_kvstore is (kvstore is not None)
    fit(1, str(tmp_path))
    assert ck.all_steps(str(tmp_path)) == [1]
    resumed = fit(2, str(tmp_path))
    assert ck.all_steps(str(tmp_path)) == [1, 2]
    got = resumed.get_params()[0]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _, state = ck.CheckpointManager(str(tmp_path)).restore()
    assert ck.OPTIMIZER_STATES_KEY in state and ck.SYMBOL_KEY in state


def test_predictor_hot_reload_swaps_without_building(tmp_path):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.observability import metrics as M
    out = mxt.sym.FullyConnected(mxt.sym.Variable("data"), num_hidden=3,
                                 name="fc")
    rs = np.random.RandomState(0)
    w0, b0 = rs.normal(0, 1, (3, 4)).astype("f"), np.zeros(3, "f")
    pred = serving.BucketedPredictor(out, {"fc_weight": w0, "fc_bias": b0},
                                     {"data": (8, 4)}, dev=CPU).warmup()
    x = rs.normal(0, 1, (2, 4)).astype("f")
    np.testing.assert_allclose(pred.predict(x)[0], x @ w0.T, rtol=1e-5)
    assert pred.loaded_step is None
    mgr = ck.CheckpointManager(str(tmp_path))
    w1 = w0 * 2.0
    mgr.save(7, {"arg:fc_weight": w1, "arg:fc_bias": b0,
                 "optimizer:states": b"ignored"})
    mgr.wait()
    n_compiled, compiles = pred.num_compiled, M.SERVE_COMPILES.value
    assert pred.hot_reload(str(tmp_path)) == 7 and pred.loaded_step == 7
    np.testing.assert_allclose(pred.predict(x)[0], x @ w1.T, rtol=1e-5)
    assert pred.num_compiled == n_compiled
    assert M.SERVE_COMPILES.value == compiles
    # a checkpoint missing a served parameter: an error, no partial swap
    mgr.save(8, {"arg:fc_weight": w0})
    mgr.wait()
    with pytest.raises(MXNetError, match="lacks served"):
        pred.hot_reload(str(tmp_path))
    np.testing.assert_allclose(pred.predict(x)[0], x @ w1.T, rtol=1e-5)
    assert pred.loaded_step == 7
    pred.close()


def test_auto_reload_follows_new_steps_and_reports_freshness(tmp_path):
    """``start_auto_reload`` swaps in each new step; a ``ResilientServer``
    over the predictor reports the reload fresh, and a failing poll keeps
    the old weights serving."""
    import time
    from mxnet_tpu_torch import serving
    out = mxt.sym.FullyConnected(mxt.sym.Variable("data"), num_hidden=2,
                                 name="fc")
    w, b = np.ones((2, 3), "f"), np.zeros(2, "f")
    pred = serving.BucketedPredictor(out, {"fc_weight": w, "fc_bias": b},
                                     {"data": (2, 3)}, dev=CPU).warmup()
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
    pred.start_auto_reload(str(tmp_path), interval_s=0.02)
    server = serving.ResilientServer(pred, max_queue=4)
    try:
        for step in (1, 2):
            mgr.save(step, {"arg:fc_weight": w * (step + 1),
                            "arg:fc_bias": b})
            deadline = time.monotonic() + 10
            while pred.loaded_step != step and time.monotonic() < deadline:
                time.sleep(0.01)
            assert pred.loaded_step == step
        x = np.ones((1, 3), "f")
        np.testing.assert_allclose(pred.predict(x)[0], x @ (3 * w).T)
        assert server.readyz()["checks"]["hot_reload_fresh"]
        mgr.save(3, {"arg:fc_weight": np.ones((5, 5), "f"),
                     "arg:fc_bias": b})              # the wrong shape
        deadline = time.monotonic() + 10
        while pred._last_reload_error is None and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert "shape" in pred._last_reload_error
        np.testing.assert_allclose(pred.predict(x)[0], x @ (3 * w).T)
    finally:
        server.close()
        pred.stop_auto_reload()
        pred.close()
