"""The port's multi-model registry against the JAX package's
(``mxnet_tpu_torch.serving.registry`` against
``mxnet_tpu.serving.registry``, the cases of ``tests/test_registry.py``).

Routing, bounds, the degradation ladder (full -> buckets_evicted ->
weights_evicted -> ``ModelUnavailable``), LRU order (decode KV pages,
then buckets, then weights), readmission bitwise, the OOM second chance,
the ``serving.evict`` fault site, the four-model flood under a budget for
two with a generative tenant, the snapshot and readiness surfaces, and the
memory arbiter.  A served model's outputs equal the JAX registry's on the
same weights (1e-5).  The JAX package's warm-compile-cache case becomes
the port's lazy rebuild case (there is no persistent compile cache).
"""
import gc
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faultinject as fi
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import memory
from mxnet_tpu_torch.observability import metrics as m
from mxnet_tpu_torch.serving import (DeadlineExceeded, ModelRegistry,
                                     ModelUnavailable, Overloaded)

CPU = mx.cpu()
NIN = 8


def _mlp_symbol(sym, pfx, nhid=16, nout=4):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=nhid,
                             name=pfx + "fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=nout, name=pfx + "fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _params(net, seed, **input_shapes):
    rs = np.random.RandomState(seed)
    arg_shapes, _, _ = net.infer_shape(**input_shapes)
    return {"arg:" + n: np.asarray(rs.normal(0, 0.1, s), "f")
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in input_shapes and not n.endswith("_label")}


def _register(reg, name, seed=0, max_batch=4, warmup=True, sym=None,
              **kw):
    sym = sym or mx.sym
    net = _mlp_symbol(sym, name)
    params = _params(net, seed, data=(max_batch, NIN))
    return reg.register(name, net, params, {"data": (max_batch, NIN)},
                        tenants=[name + "-t"], warmup=warmup,
                        server_kwargs={"watchdog_interval_s": 60.0}, **kw)


def _reg(**kw):
    return ModelRegistry(dev=CPU, **kw)


def _x(rows=2, seed=1):
    return np.asarray(np.random.RandomState(seed).normal(
        0, 1, (rows, NIN)), "f")


def _collect():
    gc.collect()
    memory.tracked_bytes()


# -- registration / routing ---------------------------------------------------

def test_register_route_and_predict():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha", seed=0)
        _register(reg, "beta", seed=1)
        a = reg.predict(tenant="alpha-t", data=_x())
        b = reg.predict(model="beta", data=_x())
        assert a[0].shape == b[0].shape == (2, 4)
        assert not np.allclose(a[0], b[0])
        reg.bind("vip", "alpha")
        np.testing.assert_array_equal(a[0],
                                      reg.predict(tenant="vip", data=_x())[0])
        with pytest.raises(MXNetError, match="no model routed"):
            reg.predict(tenant="unbound", data=_x())
        with pytest.raises(MXNetError, match="unknown model"):
            reg.predict(model="gamma", data=_x())


def test_outputs_equal_the_jax_registry():
    with _reg(budget_mb=0.0) as reg, \
            mxj.serving.ModelRegistry(budget_mb=0.0) as jreg:
        _register(reg, "alpha", seed=3)
        _register(jreg, "alpha", seed=3, sym=mxj.sym)
        np.testing.assert_allclose(reg.predict(model="alpha", data=_x())[0],
                                   jreg.predict(model="alpha", data=_x())[0],
                                   atol=1e-5)


def test_registry_bounds_duplicate_and_policy():
    with _reg(budget_mb=0.0, max_models=1) as reg:
        _register(reg, "only")
        with pytest.raises(MXNetError, match="already registered"):
            _register(reg, "only")
        with pytest.raises(MXNetError, match="registry full"):
            _register(reg, "overflow")
    with pytest.raises(MXNetError, match="evict_policy"):
        _reg(evict_policy="fifo")
    assert mx.serving.DEGRADATION_LADDER == \
        mxj.serving.registry.DEGRADATION_LADDER
    assert mx.serving.EVICT_POLICIES == mxj.serving.registry.EVICT_POLICIES


def test_registry_on_gpu_without_cuda_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(MXNetError):
        ModelRegistry()


# -- the degradation ladder ---------------------------------------------------

def test_manual_evict_readmit_round_trip_bitwise():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        before = reg.predict(model="alpha", data=_x())
        e = reg._entry("alpha")
        assert reg.degradation("alpha") == "full"
        assert e.predictor.evict_weights() > 0 and not e.predictor.resident
        assert reg.degradation("alpha") == "weights_evicted"
        with pytest.raises(mx.serving.ModelEvictedError):
            e.predictor.predict(data=_x())
        after = reg.predict(model="alpha", data=_x())
        assert e.predictor.resident
        np.testing.assert_array_equal(before[0], after[0])
        assert m.SERVE_READMITS.get(kind="model") >= 1


def test_bucket_eviction_is_phase_one_and_lru_ordered():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        _register(reg, "beta")
        ev0 = m.SERVE_EVICTIONS.value
        b0 = m.SERVE_EVICTIONS.get(kind="bucket", model="beta")
        reg._make_room(1.0, exclude=None, why="test")
        assert m.SERVE_EVICTIONS.get(kind="bucket", model="alpha") >= 1
        assert m.SERVE_EVICTIONS.get(kind="bucket", model="beta") == b0
        assert m.SERVE_EVICTIONS.value > ev0
        assert reg._entry("alpha").predictor.resident
        assert reg._entry("beta").predictor.resident
        assert reg.degradation("alpha") == "buckets_evicted"


def test_budget_pressure_evicts_lru_model():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha", warmup=False)
        _register(reg, "beta", warmup=False)
        reg._entry("alpha").last_used -= 100.0
        wb = reg._entry("alpha").predictor.host_payload_bytes()
        _collect()
        reg.budget_bytes = memory.tracked_bytes() + 0.5 * wb
        _register(reg, "gamma", seed=2, warmup=False)
        assert m.SERVE_EVICTIONS.get(kind="model", model="alpha") >= 1
        assert reg.degradation("alpha") == "weights_evicted"
        assert reg._entry("gamma").predictor.resident
        assert m.SERVE_RESIDENT_MODELS.get() == 2.0
        assert reg.predict(model="alpha", data=_x())[0].shape == (2, 4)
        assert reg._entry("alpha").predictor.resident


def test_unavailable_is_typed_with_retry_after():
    with _reg(budget_mb=0.0, evict_policy="none") as reg:
        _register(reg, "alpha")
        reg._entry("alpha").predictor.evict()
        reg.budget_bytes = max(memory.tracked_bytes(), 1.0)
        adm0 = m.SERVE_ADMITTED.value
        with pytest.raises(ModelUnavailable) as ei:
            reg.predict(model="alpha", data=_x())
        assert ei.value.retry_after_s > 0 and ei.value.model == "alpha"
        assert m.SERVE_ADMITTED.value == adm0


def test_pinned_and_busy_models_are_never_victims():
    with fi.active(fi.FaultPlan().add("serving.dispatch", "delay",
                                      delay_s=0.08)):
        with _reg(budget_mb=0.0) as reg:
            _register(reg, "pinned", pinned=True)
            _register(reg, "busy")
            _register(reg, "cold")
            fut = reg.submit(model="busy", data=_x())
            reg._make_room(float(2 ** 40), exclude=None, why="test")
            assert reg._entry("pinned").predictor.resident
            assert reg._entry("busy").predictor.resident
            assert not reg._entry("cold").predictor.resident
            fut.result(timeout=30)


def test_over_budget_registration_admits_weights_evicted():
    with _reg(budget_mb=0.0, evict_policy="none") as reg:
        _register(reg, "alpha")
        reg.budget_bytes = max(memory.tracked_bytes(), 1.0)
        _register(reg, "beta", seed=1)
        assert reg.degradation("beta") == "weights_evicted"
        reg.budget_bytes = 0.0
        reg.evict_policy = "lru"
        assert reg.predict(model="beta", data=_x())[0].shape == (2, 4)


def test_readmit_rebuilds_buckets_lazily_and_counts_readmissions():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        before = reg.predict(model="alpha", data=_x())
        e = reg._entry("alpha")
        n_buckets = e.predictor.num_compiled
        assert n_buckets > 0
        e.predictor.evict()
        rm0 = m.SERVE_READMITS.get(kind="model")
        rb0 = m.SERVE_READMITS.get(kind="bucket")
        after = reg.predict(model="alpha", data=_x())
        np.testing.assert_array_equal(before[0], after[0])
        assert m.SERVE_READMITS.get(kind="model") == rm0 + 1
        assert m.SERVE_READMITS.get(kind="bucket") >= rb0 + 1
        assert 1 <= e.predictor.num_compiled <= n_buckets


# -- chaos --------------------------------------------------------------------

def test_faultinject_evict_raise_skips_victim_keeps_it_resident():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        _register(reg, "beta")
        plan = fi.FaultPlan().add("serving.evict", "raise")
        with fi.active(plan):
            freed = reg._make_room(float(2 ** 40), exclude=None, why="test")
        assert plan.stats()["serving.evict"] > 0
        assert freed == 0.0
        assert reg._entry("alpha").predictor.resident
        assert reg._entry("beta").predictor.resident
        reg._make_room(float(2 ** 40), exclude=None, why="test")
        assert not reg._entry("alpha").predictor.resident


def test_oom_second_chance_evicts_and_retries():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "hot")
        _register(reg, "cold")
        reg.predict(model="cold", data=_x())
        time.sleep(0.01)
        reg.predict(model="hot", data=_x())
        plan = fi.FaultPlan().add("memory.oom", "raise", times=1)
        with fi.active(plan):
            out = reg.predict(model="hot", data=_x())
        assert out[0].shape == (2, 4)
        assert plan.stats()["memory.oom"] == 1
        assert not reg._entry("cold").predictor.resident
        assert m.SERVE_EVICTIONS.get(kind="model", model="cold") >= 1


def test_make_room_reclaims_decode_kv_before_buckets_or_weights():
    from mxnet_tpu_torch.serving import DecodeEngine, SequenceEvicted, ToyLM
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        _register(reg, "beta")
        with DecodeEngine(ToyLM(vocab=16, dim=8, window=4), slots=2,
                          page_tokens=4, max_pages=2, warmup=False,
                          dev=CPU) as eng:
            fut = eng.submit([1, 2], 4)
            eng.step()
            kv = eng.stats()["kv_bytes"]
            assert kv > 0
            assert reg._make_room(float(kv) / 2, exclude=None,
                                  why="test-phase0") > 0
            assert eng.stats()["kv_bytes"] < kv
            assert reg.degradation("alpha") == "full"
            assert reg.degradation("beta") == "full"
            with pytest.raises(SequenceEvicted) as ei:
                fut.result(timeout=10)
            assert ei.value.retry_after_s > 0


def test_chaos_four_models_budget_for_two_mixed_tenant_flood():
    from mxnet_tpu_torch.serving import DecodeEngine, ToyLM
    memory.wait_oom_dump(timeout=30)
    _collect()
    dev0 = memory.live_by_tag().get("serve_weights", 0)
    host0 = memory.live_by_tag("host").get("serve_host_params", 0)
    kv0 = memory.live_by_tag().get("serve_kv_pages", 0)
    names = ["m0", "m1", "m2", "m3"]
    reg = _reg(budget_mb=0.0)
    eng = None
    try:
        for i, n in enumerate(names):
            _register(reg, n, seed=i)
        eng = DecodeEngine(ToyLM(vocab=16, dim=8, window=4), slots=4,
                           page_tokens=4, max_pages=4, warmup=False,
                           name="gen", dev=CPU)
        lats = []
        for i in range(20):
            t0 = time.perf_counter()
            reg.predict(model=names[i % 4], data=_x())
            lats.append(time.perf_counter() - t0)
        p99_base = float(np.percentile(lats, 99))
        wb = reg._entry("m0").predictor.memory_stats()["weights_bytes"]
        for n in names[2:]:
            reg._entry(n).predictor.evict()
        _collect()
        reg.budget_bytes = memory.tracked_bytes() + 0.6 * wb
        plan = (fi.FaultPlan()
                .add("serving.evict", "delay", delay_s=0.002)
                .add("memory.oom", "raise", times=1, after=5))
        results = {"lat": [], "errors": [], "served": 0, "admitted": 0}
        lock = threading.Lock()

        def tenant_load(tenant, model, rounds):
            for i in range(rounds):
                t0 = time.perf_counter()
                try:
                    fut = reg.submit(model=model, tenant=tenant,
                                     data=_x(rows=2, seed=i))
                    with lock:
                        results["admitted"] += 1
                    fut.result(timeout=60)
                    with lock:
                        results["served"] += 1
                        results["lat"].append(time.perf_counter() - t0)
                except (ModelUnavailable, Overloaded, DeadlineExceeded):
                    pass
                except Exception as e:  # noqa: BLE001 — the invariant
                    with lock:
                        results["errors"].append(e)

        def gen_load(tenant, rounds):
            for i in range(rounds):
                t0 = time.perf_counter()
                try:
                    fut = eng.submit([i % 8 + 1, i % 4 + 1], 4,
                                     tenant=tenant)
                except Overloaded:
                    continue
                with lock:
                    results["admitted"] += 1
                try:
                    while not fut.done():
                        eng.step()
                    fut.result(timeout=60)
                    with lock:
                        results["served"] += 1
                        results["lat"].append(time.perf_counter() - t0)
                except (Overloaded, DeadlineExceeded):
                    pass
                except Exception as e:  # noqa: BLE001 — the invariant
                    with lock:
                        results["errors"].append(e)

        with fi.active(plan):
            threads = []
            for tenant, model in [("acme", "m0"), ("acme", "m2"),
                                  ("beta", "m1"), ("beta", "m3"),
                                  ("gamma", "m2"), ("gamma", "m0")]:
                t = threading.Thread(target=tenant_load,
                                     args=(tenant, model, 10))
                threads.append(t)
                t.start()
            for tenant in ("gen-a", "gen-b"):
                t = threading.Thread(target=gen_load, args=(tenant, 6))
                threads.append(t)
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "flood worker hung"
        assert plan.stats().get("memory.oom", 0) == 1
        assert results["errors"] == [], results["errors"]
        assert results["admitted"] > 0
        goodput = results["served"] / results["admitted"]
        assert goodput >= 0.9, (goodput, results)
        p99 = float(np.percentile(results["lat"], 99))
        assert p99 <= max(10 * p99_base, 2.0), (p99, p99_base)
        snap = mx.observability.snapshot()["serving"]
        assert sum(snap["evictions"].values()) > 0, snap["evictions"]
        assert snap["readmissions"] > 0
        assert snap["resident_models"] >= 1
        gen = eng.stats()
        assert gen["completed"] > 0, gen
        assert gen["completed"] + gen["evicted"] + gen["expired"] \
            == gen["admitted"], gen
    finally:
        if eng is not None:
            eng.close()
        reg.close()
    del reg, eng
    memory.wait_oom_dump(timeout=30)
    _collect()
    assert memory.live_by_tag().get("serve_weights", 0) == dev0
    assert memory.live_by_tag("host").get("serve_host_params", 0) == host0
    assert memory.live_by_tag().get("serve_kv_pages", 0) == kv0


# -- observability ------------------------------------------------------------

def test_snapshot_serving_schema_has_registry_block():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        reg._entry("alpha").predictor.evict()
        reg.predict(model="alpha", data=_x())
        snap = mx.observability.snapshot()["serving"]
        for k in ("evictions", "readmissions", "resident_models",
                  "model_hbm_bytes"):
            assert k in snap
        assert snap["readmissions"] >= 1
        assert snap["model_hbm_bytes"].get("alpha", 0) > 0
        assert snap["resident_models"] == 1.0


def test_registry_readyz_per_model_detail_and_budget_block():
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        _register(reg, "beta")
        reg._entry("beta").predictor.evict()
        rz = reg.readyz()
        assert rz["ready"] is True
        assert rz["models"]["alpha"]["degradation"] == "full"
        assert rz["models"]["beta"]["degradation"] == "weights_evicted"
        for k in ("budget_bytes", "tracked_bytes", "reserved_bytes",
                  "headroom_bytes", "evict_policy"):
            assert k in rz["budget"]
        srv_rz = reg._entry("beta").server.readyz()
        assert srv_rz["detail"]["degradation"] == "weights_evicted"
        assert srv_rz["detail"]["model"] == "beta"


def test_flight_timeline_records_evict_and_readmit_phases():
    from mxnet_tpu_torch.observability import flight
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        reg._make_room(float(2 ** 40), exclude=None, why="test")
        reg.predict(model="alpha", data=_x())
        summary = flight.summary()
        assert "serve_evict" in summary and "serve_readmit" in summary


def test_memory_arbitration_hook_roundtrip():
    assert memory.ensure_headroom(2 ** 40) is True
    calls = []
    prev = memory.set_budget_arbiter(
        lambda deficit, why: calls.append((deficit, why)))
    try:
        assert memory.ensure_headroom(2 ** 40, why="unit",
                                      budget=float(1)) is False
        assert calls and calls[0][1] == "unit"
    finally:
        memory.set_budget_arbiter(prev)
    with _reg(budget_mb=0.0) as reg:
        _register(reg, "alpha")
        assert not memory.ensure_headroom(2 ** 40, why="external",
                                          budget=float(1))
        assert not reg._entry("alpha").predictor.resident
