"""The port's observability and resilience layer against the JAX package's,
on the CPU: the same inputs through both, the same answers.

  * flight, goodput, timeline, report: one fixed sequence of
    ``flight.record`` spans with explicit times gives the same per-phase
    summary, per-class goodput seconds and ``goodput_pct``, the same
    Chrome events (names, categories, phases), and each package's
    ``report.summarize_run`` reads the journal the other wrote;
  * fault plans and failure classes: ``parse_plan`` of the same specs
    gives the same rules and stats, ``resilience.classify`` the same
    classes (and the port's CUDA-only classes from their messages);
  * the memory ledger: after one f32 MLP ``Trainer`` step from the same
    weights the per-tag live bytes are equal exactly; the same shapes
    give the same bytes; ``memory.oom`` gives ``DeviceMemoryError`` with
    the same top tag; the budget raises at the same registration;
  * the sanitizer: an ABBA lock order raises ``LockOrderError`` and a
    host read inside ``no_sync()`` raises ``SyncViolation`` in both;
  * the profiler and the tracing spans: one Chrome trace with the spans.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import faultinject as jfi
from mxnet_tpu import resilience as jres
from mxnet_tpu.analysis import sanitizer as jsan
from mxnet_tpu.observability import flight as jfl
from mxnet_tpu.observability import goodput as jgp
from mxnet_tpu.observability import journal as jjr
from mxnet_tpu.observability import memory as jmem
from mxnet_tpu.observability import report as jrp
from mxnet_tpu.observability import timeline as jtl
from mxnet_tpu_torch import faultinject as tfi
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch.analysis import sanitizer as tsan
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.observability import flight as tfl
from mxnet_tpu_torch.observability import goodput as tgp
from mxnet_tpu_torch.observability import journal as tjr
from mxnet_tpu_torch.observability import memory as tmem
from mxnet_tpu_torch.observability import report as trp
from mxnet_tpu_torch.observability import timeline as ttl

CPU = mxt.cpu()
PKGS = {"jax": (jfl, jgp, jjr, jtl, jrp), "torch": (tfl, tgp, tjr, ttl, trp)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path / "fl"))
    for fl, gp, jr, _, _ in PKGS.values():
        fl.enable()
        fl.reset()
        gp.enable()
        gp.reset()
        jr.configure(run_dir="")
    prev = (jfi.install(None), tfi.install(None))
    yield
    for fl, gp, jr, _, _ in PKGS.values():
        fl.reset()
        gp.reset()
        jr.configure(run_dir="")
    jfi.install(prev[0])
    tfi.install(prev[1])


# (name, cat, t0_us, t1_us, step, trace_id, labels, watch)
SPANS = [
    ("trainer_step", "step", 1e6, 1.25e6, 0, None, None, True),
    ("data_wait", "io", 1.25e6, 1.30e6, 1, None, None, False),
    ("allreduce", "kvstore", 1.05e6, 1.10e6, 0, None,
     {"mem_delta_bytes": 64, "mem_live_bytes": 4096}, False),
    ("trainer_step", "step", 1.3e6, 1.62e6, 1, None, None, True),
    ("checkpoint_block", "checkpoint", 1.62e6, 1.9e6, 2, None, None, False),
    ("whole_step", "step", 2e6, 2.2e6, 2, "ab-1", None, True),
    ("serve_dispatch", "serving", 2.2e6, 2.21e6, None, "ab-2,ab-3",
     {"bucket": "b4xs64"}, False),
    ("prefetch_wait", "io", 2.21e6, 2.4e6, None, None, None, False),
    ("trainer_step", "step", 2.4e6, 2.7e6, 3, None, None, True),
]


def _record(fl, gp):
    for name, cat, t0, t1, step, tid, labels, watch in SPANS:
        fl.record(name, cat, t0, t1, step=step, trace_id=tid,
                  labels=labels, watch=watch)
    gp.attribute("stall", 0.5)
    gp.attribute("shed", 0.0)
    with gp.replay_scope("retry_replay"):
        fl.record("trainer_step", "step", 3e6, 3.1e6, step=4)
    return fl.records()


def _goodput_view(gp):
    r = gp.report()
    classes = {c: (round(b["seconds"], 9), b["events"])
               for c, b in r["classes"].items() if c != "retry_replay"}
    return classes, round(r["attributed_s"] - r["classes"]
                          ["retry_replay"]["seconds"], 9)


def test_flight_summary_goodput_and_timeline_match_jax():
    recs = {k: _record(v[0], v[1]) for k, v in PKGS.items()}
    sums = {k: PKGS[k][3].summarize(recs[k], top=2) for k in PKGS}
    for s in sums.values():
        for ph in s.values():
            for r in ph["slowest"]:
                r.pop("t0_us")
    assert sums["torch"] == sums["jax"]
    assert sums["torch"]["trainer_step"]["count"] == 4
    assert _goodput_view(tgp) == _goodput_view(jgp)
    # goodput %: compute seconds over the wall, which the spans' explicit
    # durations set; the replay scope's own (measured) microseconds are
    # the one difference between the runs, so they are taken out
    pct = []
    for gp in (tgp, jgp):
        r = gp.report()
        replay = r["classes"]["retry_replay"]["seconds"]
        assert r["wall_s"] == pytest.approx(r["attributed_s"])
        pct.append(r["goodput_pct"] * r["wall_s"] / (r["wall_s"] - replay))
    assert pct[0] == pytest.approx(pct[1], rel=1e-12)
    assert pct[0] == pytest.approx(
        100 * 1.08 / (1.08 + 0.24 + 0.28 + 0.5))
    # the JAX package adds an achieved-flops track when its program
    # introspector holds a captured step; the port has no introspector yet
    evs = {k: [(e["name"], e.get("cat"), e["ph"])
               for e in PKGS[k][3].build_trace(recs[k], [],
                                               meta={"m": 1})["traceEvents"]
               if e["name"] != "mxnet_flops_per_s"]
           for k in PKGS}
    assert evs["torch"] == evs["jax"]
    assert ("hbm_live_bytes", None, "C") in evs["torch"]
    assert ("mxnet_badput_seconds", None, "C") in evs["torch"]


def test_flight_watchdog_and_dump(tmp_path):
    tfl.configure(slow_factor=3.0)
    for _ in range(6):
        tfl.note("trainer_step", 0.01)
    assert tfl.watch_ewma("trainer_step") == pytest.approx(0.01)
    path = tfl.dump(str(tmp_path / "f.json"))
    trace = json.load(open(path))
    assert trace["traceEvents"] == [] or isinstance(
        trace["traceEvents"], list)
    assert trace["metadata"]["reason"] == "manual"
    tfl.configure()


def _journal_run(jr, gp, run_dir):
    jr.configure(run_dir=str(run_dir))
    jr.MILESTONE_EVERY = 1
    gp.attribute("data_wait", 0.25)
    gp.observe_span("trainer_step", 1.5)
    for step in (1, 2, 3):
        jr.maybe_milestone(step, source="trainer")
    jr.emit("checkpoint_save", step=2, durable=True, bytes=10)
    jr.emit("checkpoint_save", step=4, durable=True, bytes=10)
    jr.emit("supervisor_retry", step=3, attempt=1, error="OSError: x")
    jr.note_dump("/tmp/flight-x.json", "divergence")
    jr.configure(run_dir="")
    jr.MILESTONE_EVERY = 25


def _summary_view(s):
    s = dict(s)
    for k in ("run_dir", "run_id", "wall_s"):
        s.pop(k)
    s["timeline"] = [{k: v for k, v in e.items() if k != "t"}
                     for e in s["timeline"]]
    return s


def test_report_reads_the_other_packages_journal(tmp_path):
    _journal_run(jjr, jgp, tmp_path / "jax")
    _journal_run(tjr, tgp, tmp_path / "torch")
    for d in ("jax", "torch"):
        got = trp.summarize_run(str(tmp_path / d))
        want = jrp.summarize_run(str(tmp_path / d))
        assert got == want
    a = _summary_view(trp.summarize_run(str(tmp_path / "jax")))
    b = _summary_view(trp.summarize_run(str(tmp_path / "torch")))
    assert a == b
    assert a["checkpoint"]["saves"] == 2 and a["last_step"] == 4
    assert trp.main([str(tmp_path / "jax"), "--json"]) == 0
    assert "run " in trp.render(trp.summarize_run(str(tmp_path / "torch")))


SPECS = ["serving.dispatch:delay:0.05;checkpoint.io:raise:OSError:2",
         "trainer.step:raise:OSError:1:6,data.batch:raise:"
         "DataCorruptionError:2", "device.unavailable:raise",
         "checkpoint.io:corrupt:1", "memory.oom:raise:InjectedFault:1:3"]


def _rules(fi, spec):
    return [(r.site, r.mode, r.delay_s, r.exc.__name__, r.times, r.after)
            for r in fi.parse_plan(spec).rules()]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plans_parse_and_fire_as_jax(spec):
    assert _rules(tfi, spec) == _rules(jfi, spec)
    stats = {}
    for name, fi in (("jax", jfi), ("torch", tfi)):
        plan = fi.parse_plan(spec)
        for r in plan.rules():
            r.delay_s = 0.0
        fired = []
        with fi.active(plan):
            for i in range(8):
                for site in ("serving.dispatch", "checkpoint.io",
                             "trainer.step", "data.batch",
                             "device.unavailable", "memory.oom"):
                    try:
                        fi.fire(site, corrupt=lambda: None)
                    except Exception as e:  # noqa: BLE001
                        fired.append((i, site, type(e).__name__))
        stats[name] = (plan.stats(), fired)
    assert stats["torch"] == stats["jax"]


def test_checkpoint_io_site_retries_and_corrupts(tmp_path, monkeypatch):
    """``checkpoint.io``: an OSError is retried and the save lands; a
    corrupt rule damages the committed step, which the validated restore
    skips for the one before it."""
    from mxnet_tpu_torch import checkpoint as ck
    monkeypatch.setenv("MXNET_CHECKPOINT_FSYNC", "0")
    mgr = ck.CheckpointManager(str(tmp_path), async_save=False,
                               backoff_s=0.0)
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    plan = tfi.FaultPlan().add("checkpoint.io", "raise", exc=OSError,
                               times=1)
    with tfi.active(plan):
        mgr.save(1, state)
    assert plan.stats() == {"checkpoint.io": 1}
    plan = tfi.FaultPlan().add("checkpoint.io", "corrupt", times=1)
    with tfi.active(plan):
        mgr.save(2, state)
    assert plan.stats() == {"checkpoint.io": 1}
    step, got = mgr.restore()
    assert step == 1
    np.testing.assert_array_equal(np.asarray(got["w"]), np.arange(4096))
    mgr.close()


def _fc_predictor():
    rs = np.random.RandomState(0)
    net = mxt.sym.Activation(mxt.sym.FullyConnected(
        mxt.sym.var("data"), num_hidden=4, name="fc"), act_type="relu")
    params = {"fc_weight": rs.normal(0, 1, (4, 3)).astype("f"),
              "fc_bias": rs.normal(0, 1, (4,)).astype("f")}
    pred = mxt.serving.BucketedPredictor(net, params, {"data": (4, 3)},
                                         dev=CPU)
    return pred.warmup()


def test_serving_fault_sites_fire_on_the_path(tmp_path, monkeypatch):
    """``serving.dispatch`` and ``memory.oom`` at a dispatch,
    ``serving.batcher`` in the micro-batcher's worker, and
    ``serving.hot_reload`` at a reload, which keeps the old weights."""
    from mxnet_tpu_torch import serving
    monkeypatch.setattr(tmem, "OOM_DUMP_MIN_S", 0.0)
    pred = _fc_predictor()
    x = np.ones((2, 3), "f")
    want = pred.predict(x)[0]
    plan = (tfi.FaultPlan().add("serving.dispatch", "raise", times=1)
            .add("memory.oom", "raise", times=1))
    with tfi.active(plan):
        with pytest.raises(tfi.InjectedFault):
            pred.predict(x)
        with pytest.raises(tmem.DeviceMemoryError):
            pred.predict(x)
    tmem.wait_oom_dump(10.0)
    plan = tfi.FaultPlan().add("serving.batcher", "raise", times=1)
    with tfi.active(plan):
        bat = serving.MicroBatcher(pred, max_wait_ms=1)
        with pytest.raises(serving.BatcherDeadError):
            bat.submit(data=x).result(timeout=30)
        bat.close()
    plan = tfi.FaultPlan().add("serving.hot_reload", "raise", times=1)
    with tfi.active(plan), pytest.raises(tfi.InjectedFault):
        pred.hot_reload(str(tmp_path))
    np.testing.assert_array_equal(pred.predict(x)[0], want)


def test_bad_fault_specs_raise_in_both():
    for bad in ("nosuchmode", "x:raise:NoSuchError", "x:delay",
                "x:raise:OSError:1:2:3"):
        for fi in (jfi, tfi):
            with pytest.raises(Exception):
                fi.parse_plan(bad)


def _table(mx, res, fi, mem):
    return [OSError("disk"), TimeoutError("rpc"), ConnectionError("reset"),
            fi.InjectedFault("chaos"), res.DeviceUnavailableError("gone"),
            RuntimeError("UNAVAILABLE: link down"),
            RuntimeError("DEADLINE_EXCEEDED"), mem.DeviceMemoryError("oom"),
            mem.HBMBudgetError("budget"), ValueError("shape"),
            mx.base.MXNetError("user"), res.DataCorruptionError("bad"),
            res.DataSkipBudgetError("spent"),
            RuntimeError("CUDA error: an illegal memory access was "
                         "encountered")]


def test_classify_matches_jax_and_cuda_classes():
    got = [tres.classify(e) for e in _table(mxt, tres, tfi, tmem)]
    want = [jres.classify(e) for e in _table(mxj, jres, jfi, jmem)]
    assert got == want
    # the port's CUDA classes, built from their messages
    assert tres.classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == tres.OOM
    assert tres.classify(RuntimeError(
        "CUDA out of memory. Tried to allocate 80.00 GiB")) == tres.OOM
    for msg in ("CUDA error: device-side assert triggered",
                "CUDA error: unspecified launch failure",
                "CUDA error: an illegal memory access was encountered"):
        assert tres.classify(RuntimeError(msg)) == tres.PERMANENT
    assert tmem.is_oom(torch.cuda.OutOfMemoryError("x"))
    assert tmem.is_oom(RuntimeError("CUDA out of memory."))
    assert not tmem.is_oom(RuntimeError("shape mismatch"))


# -- the memory ledger -------------------------------------------------------
def _mlp(mx, w=None):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(32, activation="relu", in_units=16))
        net.add(mx.gluon.nn.Dense(4, in_units=32))
    ctx = CPU if mx is mxt else mxj.cpu()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    if w is not None and mx is mxt:
        params_from_mxnet_tpu(w, net)
    net.hybridize()
    return net


def _ledger_after_one_step(mx, mem, w):
    mem.reset()
    mem.enable()
    net = _mlp(mx, w)
    if mx is mxj:
        for (n, p), a in zip(net.collect_params().items(), w.values()):
            p.set_data(mxj.nd.array(a))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          kvstore="tpu_sync", update_on_kvstore=False)
    rs = np.random.RandomState(1)
    ctx = CPU if mx is mxt else mxj.cpu()
    x = mx.nd.array(rs.normal(0, 1, (8, 16)).astype("f"), ctx=ctx)
    y = mx.nd.array(rs.normal(0, 1, (8, 4)).astype("f"), ctx=ctx)
    loss = mx.gluon.loss.L2Loss()
    with mx.autograd.record():
        l = loss(net(x), y)
    l.backward()
    tr.step(8)
    rep = mem.report()["device"]["tags"]
    keep = (net, tr, x, y, l)
    return {t: v["live_bytes"] for t, v in rep.items()}, keep


def test_ledger_tags_equal_jax_after_one_trainer_step():
    mxj.random.seed(0)
    w = {n: p.data().asnumpy() for n, p in
         _mlp(mxj).collect_params().items()}
    got, _k1 = _ledger_after_one_step(mxt, tmem, w)
    want, _k2 = _ledger_after_one_step(mxj, jmem, w)
    assert got == want
    assert set(got) >= {"param", "grad", "optimizer_state"}
    tmem.reset()
    jmem.reset()


def test_same_shapes_give_same_bytes_and_views_dedupe():
    for shape, dt in (((3, 5), "float32"), ((7,), "float16"),
                      ((2, 2, 2), "int32"), ((4, 3), "bfloat16")):
        a = mxt.nd.zeros(shape, ctx=CPU, dtype=dt)
        b = mxj.nd.zeros(shape, dtype=dt)
        assert tmem.nbytes_of(a) == jmem.nbytes_of(b._data)
    tmem.reset()
    t = torch.zeros(64, 64)
    tmem.register(t, tag="param")
    tmem.register(t.detach(), tag="param")      # a view of one storage
    rep = tmem.report()["device"]["tags"]["param"]
    assert rep == {"live_bytes": 64 * 64 * 4, "buffers": 1,
                   "peak_bytes": 2 * 64 * 64 * 4}
    tmem.reset()


def test_compiled_stats_of_a_capture():
    before = {"allocated_bytes.all.current": 100,
              "reserved_bytes.all.current": 1000}
    after = {"allocated_bytes.all.current": 612,
             "reserved_bytes.all.current": 900}
    assert tmem.compiled_stats_dict(before, after) == {
        "allocated_bytes": 512, "reserved_delta_bytes": -100,
        "peak_bytes": 512, "peak_estimated": False}
    assert tmem.compiled_stats_dict({}, after) == {}
    tmem.reset()
    tmem.note_compiled("whole-step", tmem.compiled_stats_dict(before, after))
    assert tmem.report()["compiled"]["whole-step"]["allocated_bytes"] == 512
    tmem.reset()


def _oom_top(mx, mem, fi, tmp_path, monkeypatch):
    monkeypatch.setattr(mem, "OOM_DUMP_MIN_S", 0.0)
    mem.reset()
    mem.enable()
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path / mx.__name__))
    ctx = CPU if mx is mxt else mxj.cpu()
    big = mx.nd.zeros((256, 256), ctx=ctx)
    small = mx.nd.zeros((4,), ctx=ctx)
    mem.register(big, tag="kvstore")
    mem.register(small, tag="param")
    plan = fi.FaultPlan().add("memory.oom", "raise", times=1)
    with fi.active(plan), pytest.raises(mem.DeviceMemoryError):
        with mem.oom_guard("optimizer.update_all"):
            fi.fire("memory.oom", at="optimizer")
    path = mem.wait_oom_dump(10.0)
    top = json.load(open(path))["report"]["top"][0]["tag"]
    mem.reset()
    return top, (big, small)


def test_injected_oom_retypes_with_the_same_top_tag(tmp_path, monkeypatch):
    got, _a = _oom_top(mxt, tmem, tfi, tmp_path, monkeypatch)
    want, _b = _oom_top(mxj, jmem, jfi, tmp_path, monkeypatch)
    assert got == want == "kvstore"


def _budget_index(mem, make):
    mem.reset()
    mem.configure(budget_mb=1.0)
    keep = []
    try:
        for i in range(10):
            keep.append(mem.register(make(), tag="param"))
    except mem.HBMBudgetError:
        return i
    finally:
        mem.configure(budget_mb=0.0)
        mem.reset()
    return None


def test_budget_raises_at_the_same_registration():
    import jax.numpy as jnp
    got = _budget_index(tmem, lambda: torch.zeros(64, 1024))
    want = _budget_index(jmem, lambda: jnp.zeros((64, 1024), jnp.float32))
    assert got == want == 4


# -- the sanitizer ------------------------------------------------------------
@pytest.mark.parametrize("san", [jsan, tsan], ids=["jax", "torch"])
def test_abba_lock_order_raises(san):
    san.reset()
    with san.sanitized():
        a = san.make_lock("test.a")
        b = san.make_lock("test.b")
        with a:
            with b:
                pass
        with pytest.raises(san.LockOrderError):
            with b:
                with a:
                    pass
    san.reset()


def test_host_read_inside_no_sync_raises_in_both():
    for mx, san in ((mxj, jsan), (mxt, tsan)):
        san.reset()
        x = mx.nd.ones((2, 2), ctx=CPU if mx is mxt else mxj.cpu())
        with san.sanitized():
            with pytest.raises(san.SyncViolation):
                with san.no_sync("test"):
                    x.asnumpy() if mx is mxj else mxt.nd.asnumpy(x)
            with san.no_sync("test"):
                pass            # no read: nothing raised
        san.reset()
    with tsan.sanitized(), pytest.raises(tsan.SyncViolation):
        with tsan.no_sync("scalar"):
            mxt.nd.asscalar(torch.ones(1))
    assert tsan.poison_donated("whole_step", torch.ones(1)) == 0


# -- profiler and spans -------------------------------------------------------
def test_profiler_dump_holds_the_spans(tmp_path):
    f = str(tmp_path / "p.json")
    tprof.set_config(filename=f)
    tprof.set_state("run")
    with mxt.observability.trace_span("whole_step", cat="trainer"):
        torch.ones(8).add_(1)
    with mxt.observability.step_span(0):
        pass
    tprof.dump_profile()
    evs = json.load(open(f))["traceEvents"]
    names = [e.get("name") for e in evs]
    assert names.count("whole_step") >= 2      # ours and the profiler's
    assert "train_step" in names
    assert not tprof.is_running()
