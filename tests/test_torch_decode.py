"""The port's continuous-batching decode engine against the JAX package's
(``mxnet_tpu_torch.serving.decode`` against ``mxnet_tpu.serving.decode``,
the cases of ``tests/test_decode.py``).

On the CPU the engine runs its step eagerly; the checks are the JAX
package's: join and leave are bitwise neutral against solo runs, one
dispatch per decode step and no build after ``warmup()``, page growth
without a rebuild, typed admission, EDF shedding, KV eviction, the fault
sites and the closed engine.  Against the JAX engine on the same
``ToyLM.init_params(seed)``: the same greedy tokens (exact), under churn
too.  ``CellModel`` and ``BucketingModule.generate`` are held against the
JAX package in ``tests/test_torch_rnn.py``; the program-audit case has no
counterpart (no HLO).
"""
import gc
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu.serving import decode as jdecode
from mxnet_tpu_torch import faultinject as fi
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import memory
from mxnet_tpu_torch.observability import metrics as m
from mxnet_tpu_torch.serving import (DeadlineExceeded, Overloaded,
                                     ResilientServer)
from mxnet_tpu_torch.serving import decode
from mxnet_tpu_torch.serving.decode import (DecodeEngine,
                                            GenerativeRouteError,
                                            SequenceEvicted, ToyLM)

CPU = mx.cpu()


def _engine(slots=4, page_tokens=4, max_pages=4, vocab=32, dim=8,
            window=4, **kw):
    return DecodeEngine(ToyLM(vocab=vocab, dim=dim, window=window),
                        slots=slots, page_tokens=page_tokens,
                        max_pages=max_pages, dev=CPU, **kw)


def _solo_tokens(prompt, max_new, **kw):
    with _engine(warmup=False, **kw) as eng:
        return eng.generate(prompt, max_new)


def _collect():
    gc.collect()
    memory.tracked_bytes()


PROMPTS = [[1], [2, 3], [4, 5, 6], [7], [8, 9], [10, 11, 12, 13]]
MAX_NEW = [3, 5, 2, 6, 4, 3]


def _churn(eng):
    futs = []
    pending = list(zip(PROMPTS, MAX_NEW))
    futs.append(eng.submit(*pending.pop(0)))
    futs.append(eng.submit(*pending.pop(0)))
    while pending:
        eng.step()
        eng.step()
        futs.append(eng.submit(*pending.pop(0)))
    eng.drain()
    return [f.result(timeout=10) for f in futs]


# -- against the JAX engine --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_tokens_equal_the_jax_engine(seed):
    """Same ``ToyLM.init_params(seed)``, same traffic: the same greedy
    tokens, solo and under churn."""
    kw = dict(slots=4, page_tokens=4, max_pages=4, warmup=False)
    jm = jdecode.ToyLM(vocab=32, dim=16, window=4)
    tm = ToyLM(vocab=32, dim=16, window=4)
    params = jm.init_params(seed)
    for k, v in tm.init_params(seed).items():
        np.testing.assert_array_equal(v, params[k])
    with jdecode.DecodeEngine(jm, params=params, **kw) as je, \
            DecodeEngine(tm, params=params, dev=CPU, **kw) as te:
        assert te.generate([1, 2, 3], 6) == je.generate([1, 2, 3], 6)
        assert _churn(te) == _churn(je)


def test_toylm_step_matches_jax_logits():
    """One step's logits and state against the JAX model: 1e-6."""
    import jax.numpy as jnp
    import torch
    jm = jdecode.ToyLM(vocab=32, dim=16, window=4)
    tm = ToyLM(vocab=32, dim=16, window=4)
    params = jm.init_params(1)
    rs = np.random.RandomState(2)
    h = rs.normal(0, 1, (3, 16)).astype("f")
    kv = rs.normal(0, 1, (3, 8, 16)).astype("f")
    tok = np.array([1, 5, 30])
    pos = np.array([0, 3, 7])
    jl, js = jm.step({k: jnp.asarray(v) for k, v in params.items()},
                     {"h": jnp.asarray(h), "kv": jnp.asarray(kv)},
                     jnp.asarray(tok, "int32"), jnp.asarray(pos, "int32"))
    tl, ts = tm.step({k: torch.tensor(v) for k, v in params.items()},
                     {"h": torch.tensor(h), "kv": torch.tensor(kv)},
                     torch.tensor(tok), torch.tensor(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(ts["kv"].numpy(), np.asarray(js["kv"]),
                               atol=1e-6)


# -- join and leave ----------------------------------------------------------

def test_solo_generation_deterministic():
    a = _solo_tokens([1, 2], 4)
    assert len(a) == 4 and a == _solo_tokens([1, 2], 4)


def test_join_leave_bitwise_vs_solo():
    expect = [_solo_tokens(p, n) for p, n in zip(PROMPTS, MAX_NEW)]
    with _engine(warmup=False) as eng:
        assert _churn(eng) == expect


def test_eos_stops_generation_early():
    first = _solo_tokens([3, 1], 5)[0]
    with _engine(warmup=False, eos=first) as eng:
        assert eng.generate([3, 1], 5) == [first]


# -- one dispatch per step, build-free growth --------------------------------

def test_one_dispatch_per_step_under_churn():
    with _engine() as eng:
        d0 = m.DISPATCHES.get(kind="decode")
        s0 = m.DECODE_STEPS.value
        compiles0 = m.SERVE_COMPILES.value
        futs = [eng.submit(p, n) for p, n in list(zip(PROMPTS, MAX_NEW))[:3]]
        eng.step()
        eng.step()
        futs += [eng.submit(p, n) for p, n in list(zip(PROMPTS, MAX_NEW))[3:]]
        eng.drain()
        for f in futs:
            f.result(timeout=10)
        st = eng.stats()
        assert st["steps"] > 0
        assert m.DISPATCHES.get(kind="decode") - d0 == st["steps"]
        assert m.DECODE_STEPS.value - s0 == st["steps"]
        assert m.SERVE_COMPILES.value == compiles0


def test_page_lattice_growth_without_rebuild():
    with _engine(slots=2, page_tokens=4, max_pages=4) as eng:
        compiles0 = m.SERVE_COMPILES.value
        fut = eng.submit([1, 2], 12)
        keys = set()
        while not fut.done():
            eng.step()
            k = eng.stats()["key"]
            if k is not None:
                keys.add(k)
        assert len(fut.result(timeout=10)) == 12
        assert len({k[1] for k in keys}) >= 2
        assert m.SERVE_COMPILES.value == compiles0


def test_warmup_builds_lattice_once_and_counts_the_program():
    from mxnet_tpu_torch.observability import introspect
    introspect.reset()
    with _engine(warmup=False) as eng:
        compiles0 = m.SERVE_COMPILES.value
        n = eng.warmup()
        assert n == len(list(eng.spec.all_keys()))
        assert m.SERVE_COMPILES.value - compiles0 == n
        eng.warmup()
        assert m.SERVE_COMPILES.value - compiles0 == n
    progs = introspect.programs()
    rec = progs["decode_step:4x4"]
    # the out projection: 2 * slots * dim * vocab
    assert rec["by_kind"]["matmul"] == 2 * 4 * 8 * 32 + 2 * 2 * 4 * 8 * 8
    introspect.reset()


# -- admission and EDF -------------------------------------------------------

def test_over_capacity_submit_rejected_typed():
    with _engine(page_tokens=4, max_pages=2) as eng:
        with pytest.raises(MXNetError, match="capacity"):
            eng.submit([1, 2], 8)
        assert eng.generate([1, 2], 6) is not None


def test_queue_full_shed_typed_overloaded():
    with _engine(warmup=False, max_queue=1) as eng:
        eng.submit([1], 2)
        with pytest.raises(Overloaded) as ei:
            eng.submit([2], 2)
        assert ei.value.retry_after_s >= 0.0
        assert eng.stats()["shed"] == 1


def test_edf_admission_shed_unmeetable_deadline():
    with _engine(warmup=False, shed_policy="deadline") as eng:
        for _ in range(8):
            eng._edf.observe(0.05)
        with pytest.raises(Overloaded, match="unmeetable"):
            eng.submit([1], 10, deadline_ms=20.0)
        fut = eng.submit([1], 10, deadline_ms=60000.0)
        eng.drain()
        assert len(fut.result(timeout=10)) == 10


def test_edf_depth_policy_never_deadline_sheds():
    with _engine(warmup=False, shed_policy="depth") as eng:
        for _ in range(8):
            eng._edf.observe(0.05)
        assert eng.submit([1], 10, deadline_ms=20.0) is not None


def test_midflight_deadline_expiry_typed():
    with _engine(warmup=False, shed_policy="depth") as eng:
        fut = eng.submit([1, 2], 12, deadline_ms=15.0)
        eng.step()
        time.sleep(0.03)
        eng.step()
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=10)
        assert eng.stats()["expired"] == 1


def test_midflight_preemption_when_unmeetable_and_work_waiting():
    with _engine(warmup=False, slots=1) as eng:
        fut_a = eng.submit([1], 8, deadline_ms=1000.0)
        eng.step()
        for _ in range(8):
            eng._edf.observe(0.5)
        fut_b = eng.submit([2], 2)
        eng.step()
        with pytest.raises(DeadlineExceeded, match="preempted"):
            fut_a.result(timeout=10)
        eng.drain()
        assert len(fut_b.result(timeout=10)) == 2


def test_step_edf_matches_jax():
    from mxnet_tpu.serving.resilience import StepEDF as JEDF
    from mxnet_tpu_torch.serving import StepEDF
    a, b = StepEDF(), JEDF()
    for s in (0.01, 0.03, 0.02, 0.5):
        a.observe(s)
        b.observe(s)
        assert a.step_s() == b.step_s()
        assert a.eta_s(17, 3) == b.eta_s(17, 3)
        assert a.unmeetable(1.0, 0.9, 5) == b.unmeetable(1.0, 0.9, 5)


# -- KV pages as an evictable resource ---------------------------------------

def test_kv_eviction_typed_retry_after():
    with _engine(warmup=False) as eng:
        ev0 = m.DECODE_KV_EVICTIONS.value
        fut = eng.submit([1, 2], 10)
        eng.step()
        eng.step()
        assert eng.stats()["kv_bytes"] > 0
        assert eng.release_kv_pages(float(2 ** 40), why="test") > 0
        with pytest.raises(SequenceEvicted) as ei:
            fut.result(timeout=10)
        assert isinstance(ei.value, Overloaded)
        assert ei.value.retry_after_s >= 0.05
        assert m.DECODE_KV_EVICTIONS.value - ev0 == 1
        assert eng.stats()["kv_bytes"] == 0
        assert len(eng.generate([1, 2], 3)) == 3


def test_reclaim_kv_pages_module_hook_finds_live_engines():
    with _engine(warmup=False, name="hooked") as eng:
        assert eng in decode.live_engines()
        eng.submit([1], 10)
        eng.step()
        assert decode.reclaim_kv_pages(float(2 ** 40), why="hook") > 0
        assert eng.stats()["kv_bytes"] == 0
    assert all(e is not eng for e in decode.live_engines())


def test_partial_reclaim_shrinks_not_drops():
    with _engine(slots=4, page_tokens=4, max_pages=2,
                 warmup=False) as eng:
        futs = [eng.submit([i + 1], 6) for i in range(4)]
        eng.step()
        bytes_full = eng.stats()["kv_bytes"]
        freed = eng.release_kv_pages(bytes_full / 4, why="partial")
        assert 0 < freed < bytes_full
        eng.drain()
        outcomes = {"ok": 0, "evicted": 0}
        for f in futs:
            try:
                assert len(f.result(timeout=10)) == 6
                outcomes["ok"] += 1
            except SequenceEvicted:
                outcomes["evicted"] += 1
        assert outcomes["ok"] >= 1 and outcomes["evicted"] >= 1, outcomes


def test_ledger_leak_gate_on_close():
    _collect()
    kv0 = memory.live_by_tag().get(decode.KV_TAG, 0)
    w0 = memory.live_by_tag().get("serve_weights", 0)
    eng = _engine(warmup=False)
    futs = [eng.submit(p, n) for p, n in zip(PROMPTS[:3], MAX_NEW[:3])]
    eng.step()
    eng.step()
    assert memory.live_by_tag().get(decode.KV_TAG, 0) > kv0
    eng.release_kv_pages(1.0, why="leak-gate")
    eng.drain()
    eng.close()
    assert all(f.done() for f in futs)
    del eng, futs
    _collect()
    assert memory.live_by_tag().get(decode.KV_TAG, 0) == kv0
    assert memory.live_by_tag().get("serve_weights", 0) == w0


def test_closed_engine_is_typed_everywhere():
    eng = _engine(warmup=False)
    fut = eng.submit([1], 5)
    eng.close()
    with pytest.raises(decode.DecodeClosedError):
        fut.result(timeout=10)
    with pytest.raises(decode.DecodeClosedError):
        eng.submit([1], 2)
    with pytest.raises(decode.DecodeClosedError):
        eng.step()
    eng.close()


def test_engine_on_gpu_without_cuda_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(MXNetError):
        DecodeEngine(ToyLM(), warmup=False)


# -- fault sites -------------------------------------------------------------

def test_faultinject_decode_step_raise_then_retry_resumes_bitwise():
    expect = _solo_tokens([5, 6], 4)
    with _engine(warmup=False) as eng:
        d0 = m.DISPATCHES.get(kind="decode")
        fut = eng.submit([5, 6], 4)
        eng.step()
        plan = fi.FaultPlan().add("serving.decode_step", "raise", times=1)
        with fi.active(plan):
            with pytest.raises(fi.InjectedFault):
                eng.step()
            assert not fut.done()
            eng.drain()
        assert plan.stats()["serving.decode_step"] == 1
        assert fut.result(timeout=10) == expect
        assert m.DISPATCHES.get(kind="decode") - d0 == eng.stats()["steps"]


def test_faultinject_decode_step_delay_feeds_edf():
    with _engine(warmup=False) as eng:
        ewma0 = eng.stats()["step_ewma_s"]
        eng.submit([1], 2)
        plan = fi.FaultPlan().add("serving.decode_step", "delay",
                                  delay_s=0.05)
        with fi.active(plan):
            eng.step()
        assert eng.stats()["step_ewma_s"] > ewma0


def test_faultinject_evict_site_fires_on_kv_reclaim():
    with _engine(warmup=False, name="evt") as eng:
        eng.submit([1], 6)
        eng.step()
        plan = fi.FaultPlan().add("serving.evict", "delay", delay_s=0.001)
        with fi.active(plan):
            assert eng.release_kv_pages(float(2 ** 40), why="site") > 0
        assert plan.stats()["serving.evict"] == 1


# -- routing pins ------------------------------------------------------------

def _fc_pred():
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                name="hfc")
    rs = np.random.RandomState(0)
    params = {"hfc_weight": rs.normal(0, 0.1, (4, 8)).astype("f"),
              "hfc_bias": np.zeros(4, "f")}
    return mx.serving.BucketedPredictor(net, params, {"data": (4, 8)},
                                        dev=CPU)


def test_request_tiers_refuse_generative_submits():
    bat = mx.serving.MicroBatcher(_fc_pred(), max_wait_ms=1.0)
    try:
        with pytest.raises(GenerativeRouteError, match="hostage"):
            bat.submit(max_new_tokens=4, data=np.zeros((1, 8), "f"))
        out = bat.submit(data=np.ones((2, 8), "f")).result(timeout=30)
        assert out[0].shape == (2, 4)
    finally:
        bat.close()
    srv = ResilientServer(_fc_pred(), watchdog_interval_s=60.0)
    try:
        with pytest.raises(GenerativeRouteError):
            srv.submit(max_new_tokens=3, data=np.zeros((1, 8), "f"))
    finally:
        srv.close()


def test_cell_model_waits_for_item_7():
    """Ported since (ROADMAP item 7a): a cell without a one-token step is
    refused with the typed route error, a steppable one is served."""
    with pytest.raises(GenerativeRouteError):
        decode.CellModel(object(), vocab=16)
    cell = mx.rnn.GRUCell(4, prefix="g_")
    with DecodeEngine(decode.CellModel(cell, vocab=16), slots=2,
                      page_tokens=4, max_pages=2, dev=CPU,
                      warmup=False) as eng:
        assert len(eng.generate([1, 2], 3)) == 3


# -- observability -----------------------------------------------------------

def test_snapshot_serving_has_decode_block_and_stats():
    with _engine(warmup=False) as eng:
        f1 = eng.submit([1], 2)
        f2 = eng.submit([2], 2)
        eng.drain()
        f1.result(timeout=10), f2.result(timeout=10)
        snap = mx.observability.snapshot()["serving"]["decode"]
        for k in ("steps", "tokens", "inflight", "kv_page_occupancy",
                  "tokens_per_s", "kv_evictions"):
            assert k in snap
        assert snap["steps"] >= 2 and snap["inflight"] == 0.0
        st = eng.stats()
        assert st["admitted"] == 2 and st["completed"] == 2
        assert st["goodput"] == 1.0 and st["tokens"] == 4
        assert st["inflight"] == 0 and st["waiting"] == 0
