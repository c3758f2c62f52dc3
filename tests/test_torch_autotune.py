"""The port's measured tuner and the serving hooks that read its decisions
(``mxnet_tpu_torch.autotune.sweep``, ``serving.buckets``,
``serving.batcher``) against the JAX package's
(``tests/test_autotune.py:106-257``).

The tuner's statistics and derived knobs equal the JAX package's on the
same inputs (exact); the lifecycle holds (a second ``tune()`` against the
same signature performs zero measured runs, also from the command line);
every consumer keeps the precedence constructor > environment > decision >
default.
"""
import logging
import types

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.autotune import sweep as jsweep
from mxnet_tpu.serving import buckets as jbk
from mxnet_tpu_torch.autotune import decisions, sweep
from mxnet_tpu_torch.autotune.superstep import SuperStepCompiler
from mxnet_tpu_torch.serving import buckets as bk

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for var in ("MXNET_SUPERSTEP_K", "MXNET_BUCKET_SIZE_MB",
                "MXNET_SERVE_BUCKETS", "MXNET_SERVE_MAX_WAIT_MS",
                "MXNET_PREFETCH_DEPTH", "MXNET_AMP", "MXNET_WHOLE_STEP"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "dec"))
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path / "fl"))
    was = decisions.ENABLED
    decisions.enable()
    decisions.reset_cache()
    yield
    decisions.reset_cache()
    if not was:
        decisions.disable()


def _build(seed=11):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu"))
        net.add(mx.gluon.nn.Dense(1))
    net.hybridize()
    net.initialize(mx.init.Xavier(), ctx=CPU)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9},
                          kvstore="tpu_sync", update_on_kvstore=False)
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.normal(0, 1, (16, 16)).astype("f"), ctx=CPU)
    y = mx.nd.array(rs.normal(0, 1, (16, 1)).astype("f"), ctx=CPU)
    return net, mx.gluon.loss.L2Loss(), tr, x, y


# -- the tuner lifecycle -----------------------------------------------------

def test_tune_persists_then_second_tune_is_pure_cache_hit():
    net, loss_fn, tr, x, y = _build()
    rec = sweep.tune(net, loss_fn, tr, x, y, ks=(2,), pairs=2,
                     bucket_candidates_mb=(8,), apply_env=False)
    assert rec is not None
    assert sweep.last_sweep_runs > 0
    assert set(rec["knobs"]) >= {"superstep_k", "bucket_size_mb",
                                 "prefetch_depth", "serve_max_wait_ms"}
    assert rec["knobs"]["prefetch_depth"] >= 2
    assert rec["evidence"]["superstep"]["2"]["scanned"] is True
    assert rec["evidence"]["batch_shape"] == [16, 16]
    decisions.reset_cache()
    net2, loss2, tr2, _, _ = _build()
    rec2 = sweep.tune(net2, loss2, tr2, x, y, ks=(2,), pairs=2,
                      bucket_candidates_mb=(8,), apply_env=False)
    assert sweep.last_sweep_runs == 0
    assert rec2["knobs"] == rec["knobs"]


def test_command_line_smoke_then_expect_cached(tmp_path, capsys):
    from mxnet_tpu_torch.autotune.__main__ import main
    d = str(tmp_path / "cli")
    assert main(["--smoke", "--cpu", "--dir", d]) == 0
    assert main(["--smoke", "--cpu", "--dir", d, "--expect-cached"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    import json
    first, second = json.loads(lines[-2]), json.loads(lines[-1])
    assert first["ok"] and first["sweep_runs"] > 0
    assert second["ok"] and second["sweep_runs"] == 0


def test_tune_disabled_warns_and_returns_none(caplog):
    decisions.disable()
    net, loss_fn, tr, x, y = _build()
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.autotune.sweep"):
        assert sweep.tune(net, loss_fn, tr, x, y) is None
    assert any("disabled" in r.message for r in caplog.records)


def test_tune_reads_the_serving_dispatch_ewma_from_the_flight_recorder(
        monkeypatch):
    from mxnet_tpu_torch.observability import flight
    flight.reset()
    for ms in (4.0, 4.0, 6.0):
        flight.record("serve_dispatch", "serving", 0.0, ms * 1e3)
    e = sweep._serve_dispatch_ewma()
    assert e == pytest.approx((0.3 * 6.0 + 0.7 * 4.0) / 1e3)
    net, loss_fn, tr, x, y = _build()
    rec = sweep.tune(net, loss_fn, tr, x, y, ks=(2,), pairs=2,
                     bucket_candidates_mb=(8,), apply_env=False)
    assert rec["knobs"]["serve_max_wait_ms"] == \
        jsweep.max_wait_from_ewma(e * 1e3)
    flight.reset()


# -- statistics and derived knobs, against the JAX package -------------------

def test_statistics_and_derived_knobs_equal_jax():
    rs = np.random.RandomState(5)
    deltas = list(rs.normal(0, 1e-3, 12))
    assert sweep.chunked_delta_pct(deltas, 0.01) == \
        jsweep.chunked_delta_pct(deltas, 0.01)
    cases = [([3] * 50 + [17] * 40 + [60] * 5, 100, 6),
             ([1, 2, 5, 9, 17, 33, 65, 120, 250, 500], 512, 3),
             ([], 64, 6), (list(rs.randint(1, 33, 200)), 32, 6)]
    for sizes, mb, rungs in cases:
        assert sweep.lattice_from_traffic(sizes, mb, rungs) == \
            jsweep.lattice_from_traffic(sizes, mb, rungs)
    lat = sweep.lattice_from_traffic([3] * 50 + [17] * 40 + [60] * 5, 100)
    assert lat[-1] == 100 and 4 in lat and 32 in lat
    for ms in (4.0, 0.1, 100.0, None, 0.0):
        assert sweep.max_wait_from_ewma(ms) == jsweep.max_wait_from_ewma(ms)
    assert sweep.max_wait_from_ewma(4.0) == 2.0


def test_serving_signature_equals_jax():
    for shapes, seq in (({"data": (32, 4)}, None),
                        ({"data": (8, 64)}, {"data": 1})):
        assert bk.BucketSpec(shapes, seq_axes=seq).signature == \
            jbk.BucketSpec(shapes, seq_axes=seq).signature


# -- consumer precedence -----------------------------------------------------

def test_superstep_k_env_beats_decision_beats_default(monkeypatch):
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    net, loss_fn, tr, x, y = _build()
    st = SuperStepCompiler(net, loss_fn, tr)
    st.step(x, y)
    st.step(x, y)
    sig = st.decision_signature
    assert sig is not None
    assert st.k == 4
    decisions.store(sig, {"superstep_k": 2})
    assert st.k == 2
    monkeypatch.setenv("MXNET_SUPERSTEP_K", "7")
    assert st.k == 7
    monkeypatch.delenv("MXNET_SUPERSTEP_K")
    st3 = SuperStepCompiler(net, loss_fn, tr, k=3)
    st3.step(x, y)
    assert st3.k == 3


def test_prefetch_depth_env_overrides_default(monkeypatch):
    from mxnet_tpu_torch import io as mio
    from mxnet_tpu_torch.gluon.data.prefetcher import AsyncPrefetcher

    pf = AsyncPrefetcher(lambda: torch.zeros(2, 2))
    assert pf._depth == 2
    pf.close()
    monkeypatch.setenv("MXNET_PREFETCH_DEPTH", "5")
    pf5 = AsyncPrefetcher(lambda: torch.zeros(2, 2))
    assert pf5._depth == 5
    pf5.close()

    class _It:
        batch_size = 2

        def next(self):
            raise StopIteration

        def reset(self):
            pass
    it5 = mio.PrefetchingIter(_It())
    assert it5._depth == 5
    it5.close()
    it3 = mio.PrefetchingIter(_It(), depth=3)
    assert it3._depth == 3
    it3.close()


def test_serve_lattice_decision_and_traffic_recorder(monkeypatch):
    shapes = {"data": (32, 4)}
    spec = bk.BucketSpec(shapes)
    assert spec.batch_buckets == bk.pow2_buckets(32)
    decisions.store(spec.signature, {"serve_buckets": "1,6,12,32"})
    decided = bk.BucketSpec(shapes)
    assert decided.batch_buckets == [1, 6, 12, 32]
    assert bk.BucketSpec(shapes, batch_buckets=[2, 32]).batch_buckets == \
        [2, 32]
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "2,8,32")
    assert bk.BucketSpec(shapes).batch_buckets == [2, 8, 32]
    monkeypatch.delenv("MXNET_SERVE_BUCKETS")
    before = len(bk.observed_traffic())
    decided.route({"data": (5, 4)})
    decided.route({"data": (11, 4)})
    traffic = bk.observed_traffic()
    assert len(traffic) == before + 2 and traffic[-2:] == (5, 11)
    decisions.disable()
    decided.route({"data": (7, 4)})
    assert len(bk.observed_traffic()) == before + 2


def test_a_fresh_predictor_and_batcher_read_the_persisted_decision():
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                name="fc")
    params = {"fc_weight": torch.ones(3, 4), "fc_bias": torch.zeros(3)}
    probe = bk.BucketSpec({"data": (16, 4)})
    decisions.store(probe.signature, {"serve_buckets": "3,16",
                                      "serve_max_wait_ms": 1.5})
    pred = mx.serving.BucketedPredictor(sym, params, {"data": (16, 4)},
                                        dev=CPU)
    assert pred.spec.batch_buckets == [3, 16]
    mb = mx.serving.MicroBatcher(pred)
    assert mb._max_wait_s == pytest.approx(0.0015)
    out = mb.submit(data=np.ones((2, 4), "f")).result(timeout=10)
    assert np.allclose(out[0], 4.0)
    mb.close()


def test_batcher_max_wait_decision_and_env(monkeypatch):
    from mxnet_tpu_torch.serving.batcher import MicroBatcher
    sig = "cafecafecafecafe"
    decisions.store(sig, {"serve_max_wait_ms": 3.5})
    pred = types.SimpleNamespace(
        spec=types.SimpleNamespace(signature=sig, max_batch=8))
    mb = MicroBatcher(pred)
    assert mb._max_wait_s == pytest.approx(0.0035)
    mb.close()
    monkeypatch.setenv("MXNET_SERVE_MAX_WAIT_MS", "1.0")
    mb2 = MicroBatcher(pred)
    assert mb2._max_wait_s == pytest.approx(0.001)
    mb2.close()
    mb3 = MicroBatcher(pred, max_wait_ms=0.5)
    assert mb3._max_wait_s == pytest.approx(0.0005)
    mb3.close()


def test_trainer_bucket_size_decision(monkeypatch):
    net, loss_fn, tr, x, y = _build()
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    sig = tuple((tuple(p.data().shape), mx.gluon.trainer.dtype_name(
        p.data().dtype)) for p in net.collect_params().values()
        if p.grad_req != "null")
    decisions.store(decisions.model_signature(sig),
                    {"bucket_size_mb": 0.0001})
    tr.step(16)
    many = len(tr._bucketer.sizes)
    assert many > 1
    net2, loss2, tr2, _, _ = _build()
    with mx.autograd.record():
        loss = loss2(net2(x), y)
    loss.backward()
    monkeypatch.setenv("MXNET_BUCKET_SIZE_MB", "32")
    tr2.step(16)
    assert len(tr2._bucketer.sizes) < many
