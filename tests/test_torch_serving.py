"""The port's serving tier against the JAX package's, on the CPU.

``BucketedPredictor`` serves a small flash TransformerLM (vocab 50, dim
32, 2 layers, 2 heads, max_len 128, float32) from one graph JSON and one
params file, in both packages, over batch buckets [1, 2, 4] and sequence
buckets [16, 32, 64]: outputs agree within 1e-5 for a padded batch, a
padded sequence and an oversize request chunked over the largest bucket,
and files written by either package serve in the other.  ``MicroBatcher``
and ``ResilientServer`` cases mirror ``tests/test_serving.py`` and
``tests/test_resilience.py`` on a small FullyConnected graph; a slow
dispatch is a sleep wrapped around the predictor's ``_dispatch``.  Every
predictor runs with ``dev=mx.cpu()``.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch import MXNetError, serving
from mxnet_tpu_torch.observability import metrics as M
from mxnet_tpu_torch.serving import (BucketSpec, DeadlineExceeded,
                                     Overloaded, ResilientServer)
from mxnet_tpu_torch.serving.buckets import (covering_bucket, pad_to_shape,
                                             pow2_buckets)

CPU = mxt.cpu()
KW = dict(vocab=50, dim=32, num_layers=2, num_heads=2, max_len=128,
          attn_type="flash")
LATTICE = dict(seq_axes={"data": 1}, batch_buckets=[1, 2, 4],
               seq_buckets=[16, 32, 64])
SHAPE = {"data": (4, 64)}


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The LM's graph JSON and a params file, both written by JAX."""
    d = tmp_path_factory.mktemp("lm")
    mxj.random.seed(0)
    jnet = JaxLM(**KW)
    jnet.initialize(mxj.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    jnet(mxj.nd.array(np.zeros((1, 8), np.float32)))
    path = str(d / "lm.params")
    mxj.nd.save(path, {n: p.data() for n, p in
                       jnet.collect_params().items()})
    return jnet(mxj.sym.var("data")).tojson(), path


@pytest.fixture(scope="module")
def preds(lm):
    js, path = lm
    jp = jserving.BucketedPredictor(js, path, SHAPE, **LATTICE)
    tp = serving.BucketedPredictor(js, path, SHAPE, dev=CPU, **LATTICE)
    return jp, tp


def _ids(shape, seed=1):
    return np.random.RandomState(seed).randint(0, 50, shape).astype(
        np.float32)


# -- bucket math (the JAX package's functions are the reference) -------------
BUCKET_CASES = [
    ("pow2", lambda B: B.pow2_buckets(9)),
    ("pow2 lo", lambda B: B.pow2_buckets(100, lo=16)),
    ("covering", lambda B: [B.covering_bucket([2, 4, 8], n)
                            for n in (1, 3, 8, 9)]),
    ("pad", lambda B: B.pad_to_shape(np.ones((2, 3), "f"), (4, 5)).tolist()),
    ("keys", lambda B: B.BucketSpec({"data": (4, 64)}, **LATTICE).all_keys()),
    ("default keys", lambda B: B.BucketSpec(
        {"data": (4, 1024)}, seq_axes={"data": 1}).all_keys()),
    ("route", lambda B: [B.BucketSpec({"data": (4, 64)}, **LATTICE).route(
        {"data": s}) for s in ((1, 1), (3, 50), (4, 64), (9, 16))]),
    ("bucket shapes", lambda B: B.BucketSpec(
        {"data": (4, 64)}, **LATTICE).bucket_input_shapes((2, 32))),
    ("waste", lambda B: B.BucketSpec(
        {"data": (4, 64)}, **LATTICE).waste_fraction(
        (4, 64), {"data": (3, 50)})),
    ("pages", lambda B: B.page_lattice(4, 8).all_keys()),
]


@pytest.mark.parametrize("name,fn", BUCKET_CASES,
                         ids=[c[0] for c in BUCKET_CASES])
def test_bucket_math_matches_jax(name, fn):
    assert fn(serving.buckets) == fn(jserving.buckets)


def test_bucket_env_and_validation(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "2,16,4")
    assert BucketSpec({"data": (16, 8)}).batch_buckets == [2, 4, 16]
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "banana")
    with pytest.raises(MXNetError, match="MXNET_SERVE_BUCKETS"):
        BucketSpec({"data": (16, 8)})
    monkeypatch.delenv("MXNET_SERVE_BUCKETS")
    with pytest.raises(MXNetError, match="positive"):
        BucketSpec({"data": (4, 3)}, batch_buckets=[0, 4])
    with pytest.raises(MXNetError):
        pow2_buckets(0)
    with pytest.raises(MXNetError, match="cannot pad"):
        pad_to_shape(np.ones((5, 3), "f"), (4, 3))
    assert covering_bucket([2, 4], 5) is None


# -- the LM served by both packages -------------------------------------------
@pytest.mark.parametrize("shape", [(3, 64), (1, 50), (6, 64)],
                         ids=["padded batch", "padded seq", "oversize"])
def test_bucketed_predictor_matches_jax(preds, shape):
    jp, tp = preds
    x = _ids(shape)
    want = jp.predict(data=x)[0]
    got = tp.predict(data=x)[0]
    # rows slice back on axis 0 only: a padded sequence returns the
    # bucket's width, in both packages
    assert got.shape == want.shape == (shape[0], 64, 50)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_files_written_by_the_port_serve_in_jax(lm, tmp_path):
    js, path = lm
    net = mxt.sym.load_json(js)
    params = mxt.nd.load(path, ctx=CPU)
    port_path = str(tmp_path / "port.params")
    mxt.nd.save(port_path, params)
    x = _ids((2, 32), seed=4)
    jp = jserving.BucketedPredictor(net.tojson(), port_path, SHAPE,
                                    **LATTICE)
    tp = serving.BucketedPredictor(net, params, SHAPE, dev=CPU, **LATTICE)
    np.testing.assert_allclose(tp.predict(x)[0], jp.predict(x)[0],
                               rtol=1e-5, atol=1e-5)


def test_mxpred_predictor_matches_jax(lm, tmp_path):
    js, path = lm
    (tmp_path / "lm.json").write_text(js)
    x = _ids((2, 16), seed=5)
    jp = mxj.predictor.create(str(tmp_path / "lm.json"), path,
                              {"data": (2, 16)})
    tp = mxt.predictor.create(str(tmp_path / "lm.json"), path,
                              {"data": (2, 16)}, dev=CPU)
    with open(path, "rb") as f:
        blob = mxt.predictor.Predictor(js, f.read(), {"data": (2, 16)},
                                       dev=CPU)
    for p in (jp, tp, blob):
        p.set_input("data", x)
        p.forward()
    assert tp.num_outputs == jp.num_outputs == 1
    np.testing.assert_allclose(tp.get_output(0), jp.get_output(0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(blob.get_output(0), tp.get_output(0))
    tp.reshape({"data": (1, 32)})
    tp.set_input("data", _ids((32,), seed=6))     # flat, same size
    tp.forward()
    assert tp.get_output().shape == (1, 32, 50)
    with pytest.raises(MXNetError, match="elements"):
        tp.set_input("data", np.ones(5, "f"))


def test_compiles_stay_flat_after_warmup(lm):
    js, path = lm
    tp = serving.BucketedPredictor(js, path, SHAPE, dev=CPU, **LATTICE)
    c0, b0 = M.SERVE_COMPILES.value, M.SERVE_BATCHES.value
    tp.warmup()
    assert M.SERVE_COMPILES.value - c0 == len(tp.spec.all_keys()) == 9
    assert tp.num_compiled == 9
    c1 = M.SERVE_COMPILES.value
    for shape in ((1, 3), (2, 17), (4, 64), (3, 33), (1, 64)):
        tp.predict(data=_ids(shape))
    assert M.SERVE_COMPILES.value == c1          # no bucket escaped
    assert M.SERVE_BATCHES.value - b0 == 5       # one dispatch each
    snap = mxt.observability.snapshot()["serving"]
    assert set(snap) <= set(mxj.observability.snapshot()["serving"])
    assert 0.0 <= snap["padding_waste"] < 1.0
    assert "mxnet_serve_compiles_total" in M.render_prometheus()


def test_non_batch_major_output_rejected_at_warmup():
    """Padding would corrupt a non-batch-major output: refused loudly when
    the bucket is built, not at slice time."""
    net = mxt.sym.reshape(mxt.sym.var("data"), shape=(-1,))
    pred = serving.BucketedPredictor(net, {}, {"data": (4, 3)},
                                     batch_buckets=[4], dev=CPU)
    with pytest.raises(MXNetError, match="batch-major"):
        pred.warmup()


def test_evict_and_readmit_from_the_host_payload(lm):
    js, path = lm
    tp = serving.BucketedPredictor(js, path, SHAPE, dev=CPU, **LATTICE)
    x = _ids((2, 16))
    want = tp.predict(data=x)[0]
    assert tp.evict() > 0 and not tp.resident and tp.num_compiled == 0
    with pytest.raises(serving.ModelEvictedError):
        tp.predict(data=x)
    r0 = M.SERVE_READMITS.value
    tp.readmit()
    np.testing.assert_array_equal(tp.predict(data=x)[0], want)
    assert M.SERVE_READMITS.value - r0 == 2      # the model, then a bucket
    with pytest.raises(NotImplementedError, match="queue item 4"):
        tp.hot_reload("ckpt")
    tp.close()
    with pytest.raises(MXNetError, match="closed"):
        tp.readmit()


def test_entry_points_need_cuda_unless_cpu_is_passed(lm, monkeypatch):
    js, path = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(MXNetError, match="cpu"):
        serving.BucketedPredictor(js, path, SHAPE, **LATTICE)
    with pytest.raises(MXNetError, match="cpu"):
        mxt.predictor.Predictor(js, path, {"data": (1, 16)})
    with mxt.cpu():                               # or a cpu scope
        assert serving.BucketedPredictor(js, path, SHAPE,
                                         **LATTICE)._device.type == "cpu"


# -- MicroBatcher and ResilientServer on a small graph ------------------------
def _fc_predictor(max_batch=8, delay_s=0.0):
    rs = np.random.RandomState(0)
    net = mxt.sym.Activation(mxt.sym.FullyConnected(
        mxt.sym.var("data"), num_hidden=4, name="fc"), act_type="relu")
    params = {"fc_weight": rs.normal(0, 1, (4, 3)).astype("f"),
              "fc_bias": rs.normal(0, 1, (4,)).astype("f")}
    pred = serving.BucketedPredictor(net, params, {"data": (max_batch, 3)},
                                     dev=CPU)
    pred.warmup()
    if delay_s:
        dispatch = pred._dispatch

        def slow(key, padded):
            time.sleep(delay_s)
            return dispatch(key, padded)
        pred._dispatch = slow
    return pred


def _x(rows=1, seed=0):
    return np.random.RandomState(seed).normal(0, 1, (rows, 3)).astype("f")


def test_microbatcher_coalesces_and_returns_the_solo_rows():
    pred = _fc_predictor()
    xs = [_x(1, s) for s in range(6)]
    refs = [pred.predict(x)[0] for x in xs]
    b0 = M.SERVE_BATCHES.value
    with serving.MicroBatcher(pred, max_wait_ms=200) as bat:
        outs = [f.result(timeout=30) for f in
                [bat.submit(data=x) for x in xs]]
    for ref, out in zip(refs, outs):
        np.testing.assert_allclose(out[0], ref, rtol=1e-6, atol=1e-7)
    assert M.SERVE_BATCHES.value - b0 < len(xs)


def test_microbatcher_flushes_at_max_batch_and_chunks_oversize():
    pred = _fc_predictor(max_batch=4)
    xs = [_x(2, s) for s in range(5)] + [_x(11, 9)]
    refs = [pred.predict(x)[0] for x in xs]
    with serving.MicroBatcher(pred, max_wait_ms=100, max_batch=4) as bat:
        outs = [f.result(timeout=30) for f in
                [bat.submit(data=x) for x in xs]]
    for ref, out in zip(refs, outs):
        assert out[0].shape == ref.shape
        np.testing.assert_allclose(out[0], ref, rtol=1e-6, atol=1e-7)


def test_microbatcher_errors_stay_with_their_request():
    pred = _fc_predictor()
    with serving.MicroBatcher(pred, max_wait_ms=200) as bat:
        bad = bat.submit(data=np.ones((2, 4), "f"))    # wrong feature dim
        good = bat.submit(data=_x(2))
        with pytest.raises(MXNetError, match="dim 1"):
            bad.result(timeout=30)
        assert good.result(timeout=30)[0].shape == (2, 4)
        with pytest.raises(serving.GenerativeRouteError):
            bat.submit(max_new_tokens=8, data=_x())
    with pytest.raises(serving.BatcherClosedError, match="closed"):
        bat.submit(data=_x())


def test_microbatcher_dispatch_error_reaches_every_caller():
    pred = _fc_predictor()

    def broken(key, padded):
        raise MXNetError("dispatch failed")
    pred._dispatch = broken
    with serving.MicroBatcher(pred, max_wait_ms=50) as bat:
        futs = [bat.submit(data=_x()) for _ in range(3)]
        for f in futs:
            with pytest.raises(MXNetError, match="dispatch failed"):
                f.result(timeout=30)


def test_server_sheds_past_max_queue_with_retry_after():
    pred = _fc_predictor(delay_s=0.05)
    with ResilientServer(pred, max_queue=2, max_batch=1, max_wait_ms=0,
                         shed_policy="depth") as srv:
        srv.predict(data=_x())                   # primes the EWMA
        futs, sheds = [], []
        for _ in range(12):
            try:
                futs.append(srv.submit(data=_x()))
            except Overloaded as e:
                sheds.append(e)
        outs = [f.result(timeout=30) for f in futs]
        assert srv.readyz()["ready"] and srv.healthz()["ok"]
    assert sheds and all(e.retry_after_s > 0 for e in sheds)
    assert all(o[0].shape == (1, 4) for o in outs)
    st = srv.stats()["tenants"]["default"]
    assert st["shed"] == len(sheds) and st["served"] == len(futs) + 1


def test_server_expires_late_work_and_sheds_unmeetable_deadlines():
    pred = _fc_predictor(delay_s=0.08)
    with ResilientServer(pred, max_queue=16, max_batch=1, max_wait_ms=0,
                         shed_policy="depth") as srv:
        blocker = srv.submit(data=_x())
        time.sleep(0.02)
        doomed = [srv.submit(deadline_ms=10, data=_x()) for _ in range(3)]
        ok = srv.submit(deadline_ms=5000, data=_x())
        blocker.result(timeout=30)
        for f in doomed:
            with pytest.raises(DeadlineExceeded, match="dropped"):
                f.result(timeout=30)
        assert ok.result(timeout=30)[0].shape == (1, 4)
    assert srv.stats()["expired_dispatches"] == 0
    assert srv.stats()["tenants"]["default"]["expired"] == 3
    with ResilientServer(pred, max_queue=32, max_batch=1,
                         max_wait_ms=0) as srv:
        srv.predict(data=_x())                    # EWMA ~80 ms
        blocker = srv.submit(data=_x())
        queued = [srv.submit(deadline_ms=10000, data=_x())
                  for _ in range(3)]
        with pytest.raises(Overloaded, match="deadline"):
            srv.submit(deadline_ms=1, data=_x())
        for f in [blocker] + queued:
            f.result(timeout=30)


def test_server_readiness_priority_and_close():
    pred = _fc_predictor(delay_s=0.08)
    srv = ResilientServer(pred, max_queue=16, max_batch=1, max_wait_ms=0)
    assert srv.warmup().readyz()["ready"]
    assert srv.readyz()["checks"]["warmup_complete"]
    done = []
    blocker = srv.submit(data=_x())
    time.sleep(0.02)
    lo = srv.submit(priority=0, data=_x())
    hi = srv.submit(priority=5, data=_x())
    lo.add_done_callback(lambda f: done.append("lo"))
    hi.add_done_callback(lambda f: done.append("hi"))
    for f in (blocker, lo, hi):
        f.result(timeout=30)
    assert done.index("hi") < done.index("lo")
    bad = srv.submit(data=np.ones((1, 5), "f"))
    with pytest.raises(MXNetError, match="dim 1"):
        bad.result(timeout=30)
    srv.close()
    assert not srv.readyz()["ready"] and not srv.healthz()["ok"]
    with pytest.raises(serving.BatcherClosedError):
        srv.submit(data=_x())


def test_server_tenants_are_isolated_and_bounded():
    pred = _fc_predictor(delay_s=0.03)
    with ResilientServer(pred, max_queue=2, max_batch=1, max_wait_ms=0,
                         shed_policy="depth", max_tenants=2) as srv:
        flood, shed = [], 0
        for _ in range(8):
            try:
                flood.append(srv.submit(tenant="a", data=_x()))
            except Overloaded:
                shed += 1
        calm = srv.submit(tenant="b", data=_x())   # b's queue is its own
        assert shed and calm.result(timeout=30)[0].shape == (1, 4)
        for f in flood:
            f.result(timeout=30)
        srv.submit(tenant="c", data=_x()).result(timeout=30)  # evicts idle
    assert set(srv.stats()["tenants"]) <= {"a", "b", "c"}
    assert len(srv.stats()["tenants"]) <= 2


def test_threads_racing_on_a_cold_predictor():
    """More threads than cores predict on a predictor with no bucket
    built, with a short switch interval: each bucket is built exactly once,
    no count is lost, and every caller gets its own rows."""
    pred = _fc_predictor()
    xs = [_x(1 + s % 8, s) for s in range(48)]
    refs = [pred.predict(x)[0] for x in xs]
    for key in pred.spec.all_keys():
        pred.evict_bucket(key)
    outs = [None] * len(xs)
    c0, b0 = M.SERVE_COMPILES.value, M.SERVE_BATCHES.value

    def worker(i):
        outs[i] = pred.predict(xs[i])[0]

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(xs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert M.SERVE_COMPILES.value - c0 == len(pred.spec.all_keys())
    assert M.SERVE_BATCHES.value - b0 == len(xs)
    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(out, ref)
