"""The port's program introspector against the JAX package's
(``mxnet_tpu_torch.observability.introspect`` against
``mxnet_tpu.observability.introspect``).

The port counts a program's aten ops where the JAX package reads XLA's
cost analysis, so the checks are:

  * the counted matrix-product and attention flops of a 2-layer
    TransformerLM whole step (dim 64) equal ``experiments/lm_mfu_probe.py``'s
    formula exactly, with the flash kernel's formula and with the plain
    dense attention alike;
  * on ``tests/test_introspect.py``'s pinned net (4 x Dense(16, relu) +
    Dense(1), whole step) the per-layer rows carry the JAX package's layer
    names, each layer's matrix-product flops equal the dot flops of the JAX
    program's HLO (operand shapes resolved from the HLO itself: the JAX
    parser's own ``parse_hlo_flops`` sees no operand types in this jax's
    text and books 2 flops per output element), and >= 90 % is attributed;
  * the step totals against the JAX package's ``step_flops()``: measured
    0.7 % apart for the whole step (tolerance 2 %) and 6.9 % for the fused
    path, whose JAX ``gluon:bwd`` program holds a recompute of the forward
    (compared with the JAX ``gluon:bwd`` + ``fused_update``; tolerance 10 %);
  * MFU math with an injected peak, the card's step time preferred to the
    host span, the H100 peak table, the sentinel cases of
    ``tests/test_introspect.py:415-609``, and the dispatch gauges against
    the JAX package's after the same calls.
"""
import json
import logging
import os
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.wholestep import WholeStepCompiler as JaxWholeStep
from mxnet_tpu.observability import introspect as jint
from mxnet_tpu.observability import metrics as jm
from mxnet_tpu_torch.gluon.wholestep import WholeStepCompiler
from mxnet_tpu_torch.observability import flight, goodput
from mxnet_tpu_torch.observability import introspect
from mxnet_tpu_torch.observability import metrics as m

CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("MXNET_WHOLE_STEP", "MXNET_PEAK_FLOPS", "MXNET_SUPERSTEP_K",
              "MXNET_PERF_BASELINE_DIR", "MXNET_COMPILE_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    for mod in (introspect, jint):
        mod.enable()
        mod.reset()
        mod.configure(hlo=False, sentinel_every=1, regression_factor=1.5,
                      regression_min_s=300.0)
    flight.reset()
    goodput.reset()
    yield
    for mod in (introspect, jint):
        mod.reset()
        mod.configure(hlo=False, sentinel_every=25, regression_factor=1.5,
                      regression_min_s=300.0)
    flight.reset()
    goodput.reset()


def _ctx(mx):
    return CPU if mx is mxt else mxj.cpu()


def _arr(mx, a):
    return mx.nd.array(a, ctx=CPU) if mx is mxt else mx.nd.array(a)


def _mlp(mx, depth=4, width=16, seed=11):
    """``tests/test_introspect.py``'s pinned net, under a fixed prefix so
    both packages name its layers alike."""
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        for _ in range(depth):
            net.add(mx.gluon.nn.Dense(width, activation="relu"))
        net.add(mx.gluon.nn.Dense(1))
    net.hybridize()
    net.initialize(mx.init.Xavier(), ctx=_ctx(mx))
    return net


def _trainer(mx, net):
    return mx.gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9},
                            kvstore="tpu_sync", update_on_kvstore=False)


def _data(seed=0, shape=(8, 16)):
    rs = np.random.RandomState(seed)
    return (rs.normal(0, 1, shape).astype("f"),
            rs.normal(0, 1, (shape[0], 1)).astype("f"))


def _whole(mx, monkeypatch, steps=3, net=None):
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    net = net or _mlp(mx)
    cls = WholeStepCompiler if mx is mxt else JaxWholeStep
    st = cls(net, mx.gluon.loss.L2Loss(), _trainer(mx, net))
    x, y = _data()
    for _ in range(steps):
        st.step(_arr(mx, x), _arr(mx, y))
    return st


def _fused(mx, steps=2):
    net = _mlp(mx)
    tr = _trainer(mx, net)
    x, y = _data()
    xs, ys = _arr(mx, x), _arr(mx, y)
    for _ in range(steps):
        with mx.autograd.record():
            loss = mx.gluon.loss.L2Loss()(net(xs), ys)
        loss.backward()
        tr.step(x.shape[0])
    return net, tr


def _warm(phase, dur_s, n=6):
    for _ in range(n):
        flight.note(phase, dur_s)


# -- flops -------------------------------------------------------------------

def _lm_step_counts(monkeypatch, attn):
    """One whole step of a 2-layer TransformerLM (dim 64, vocab 128, T=32,
    B=2): the counted record and the probe formula."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    V, D, L, H, T, B = 128, 64, 2, 4, 32, 2
    mxt.random.seed(3)
    net = TransformerLM(vocab=V, dim=D, num_layers=L, num_heads=H,
                        max_len=T, attn_type=attn)
    net.initialize(mxt.init.Xavier(), ctx=CPU)
    net.hybridize()
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    st = WholeStepCompiler(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                           _trainer(mxt, net))
    toks = np.random.RandomState(0).randint(0, V, (B, T + 1))
    for _ in range(2):      # the first resolves the deferred shapes
        st.step(_arr(mxt, toks[:, :-1].astype("f")),
                _arr(mxt, toks[:, 1:].astype("f")))
    p_matmul = L * (4 * D * D + 2 * D * 4 * D) + D * V
    probe = 3 * (2 * p_matmul * B * T + L * 4 * B * T * T * D)
    return introspect.programs()["whole_step"], probe


def test_lm_step_matmul_flops_equal_the_probe_formula(monkeypatch):
    """Exact, with the flash kernel's formula (the attention rows) and with
    the plain dense attention's matrix products (no kernel row)."""
    rec, probe = _lm_step_counts(monkeypatch, "flash")
    k = rec["by_kind"]
    assert k["matmul"] + k["attention"] == probe
    assert k["attention"] == 3 * 2 * 4 * 2 * 32 * 32 * 64
    introspect.reset()
    rec, probe = _lm_step_counts(monkeypatch, "dense")
    k = rec["by_kind"]
    assert k.get("attention", 0) == 0
    assert k["matmul"] == probe
    assert rec["dtype"] == "float32"


def test_flash_formula_equals_the_plain_versions_products():
    """``FlashAttentionFn`` forward+backward books 12*B*H*T*T*D: what
    autograd through the plain dense attention counts in matrix products."""
    from mxnet_tpu_torch.kernels.flash_attention import dense_reference
    from mxnet_tpu_torch.ops.flash_attention import FlashAttentionFn
    rs = np.random.RandomState(1)
    q, k, v = (torch.tensor(rs.normal(0, 1, (2, 3, 16, 8)).astype("f"),
                            requires_grad=True) for _ in range(3))
    counts = []
    for fn in (lambda: FlashAttentionFn.apply(q, k, v, 0.3, True),
               lambda: dense_reference(q, k, v, 0.3, True)):
        c = introspect.Count()
        with c:
            o = fn()
            torch.autograd.grad(o.sum(), (q, k, v))
        counts.append(c.by_kind.get("attention", 0)
                      + c.by_kind.get("matmul", 0))
    assert counts[0] == counts[1] == 12 * 2 * 3 * 16 * 16 * 8


def _dot_flops_by_layer(hlo: str) -> dict:
    """Dot flops per layer from the JAX program's HLO text, each dot's lhs
    shape resolved from the instruction that defines it."""
    shapes = {}
    for line in hlo.splitlines():
        mm = re.match(r"\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*\w+\[([0-9,]*)\]",
                      line)
        if mm:
            shapes[mm.group(1)] = [int(d) for d in mm.group(2).split(",")
                                   if d]
    known = jint.known_scopes()
    out = {}
    for line in hlo.splitlines():
        mm = re.match(r"\s*(?:ROOT\s+)?%[\w.\-]+\s*=\s*\w+\[([0-9,]*)\]\S*"
                      r"\s+dot\(%([\w.\-]+),", line)
        if not mm:
            continue
        out_elems = int(np.prod([int(d) for d in mm.group(1).split(",")
                                 if d] or [1]))
        lhs = shapes[mm.group(2)]
        cd = re.search(r"lhs_contracting_dims=\{([0-9,]+)\}", line)
        contracted = int(np.prod([lhs[int(i)]
                                  for i in cd.group(1).split(",")]))
        meta = re.search(r'op_name="([^"]+)"', line)
        layer = jint._layer_of(jint._scope_of(meta.group(1), known))
        out[layer] = out.get(layer, 0.0) + 2.0 * out_elems * contracted
    return out


def test_per_layer_matches_jax_layers_and_dot_flops(monkeypatch):
    jint.configure(hlo=True)
    introspect.configure(hlo=True)
    _whole(mxj, monkeypatch)
    st = _whole(mxt, monkeypatch)
    assert st.active
    jrows = jint.per_layer("whole_step")
    rows = introspect.per_layer("whole_step")
    jlayers = {r["layer"] for r in jrows} - {jint.UNATTRIBUTED}
    layers = {r["layer"] for r in rows} - {introspect.UNATTRIBUTED}
    dense = {n for n in jlayers if re.fullmatch(r"net_dense\d", n)}
    assert dense == {f"net_dense{i}" for i in range(5)}
    assert dense | {"optimizer"} <= layers
    # every JAX layer the port also runs as a node has the port's row
    assert {n for n in jlayers if n.startswith("net_")} <= layers
    jdots = _dot_flops_by_layer(jint.programs()["whole_step"]["hlo"])
    mm = introspect.parse_hlo_flops(
        introspect.programs()["whole_step"]["hlo"],
        kinds=("matmul", "conv"))
    # net_dense4's input gradient is an outer product (contracting size
    # 1), which XLA rewrites into a multiply: 2*8*16 flops off the dots
    jdots["net_dense4"] += 2 * 8 * 16
    assert mm == jdots
    assert introspect.attributed_pct("whole_step") >= 90.0
    assert 99.0 <= sum(r["pct"] for r in rows) <= 101.0


def test_step_totals_within_tolerance_of_jax(monkeypatch):
    _whole(mxj, monkeypatch)
    _whole(mxt, monkeypatch)
    jf, _, jph = jint.step_flops()
    tf, tb, tph = introspect.step_flops()
    assert jph == tph == "whole_step"
    assert abs(tf - jf) <= 0.02 * jf, (tf, jf)
    assert tb > 0
    monkeypatch.setenv("MXNET_WHOLE_STEP", "0")
    for mod in (introspect, jint):
        mod.reset()
    _fused(mxj)
    _fused(mxt)
    jp, tp = jint.programs(), introspect.programs()
    assert {"gluon:fwd", "gluon:bwd", "fused_update"} <= set(tp)
    tf, _, tph = introspect.step_flops()
    assert tph == "trainer_step"
    assert tf == sum(tp[n]["flops"] for n in introspect.FUSED_STEP_PROGRAMS)
    assert tp["gluon:fwd"]["flops"] == jp["gluon:fwd"]["flops"]
    jwork = jp["gluon:bwd"]["flops"] + jp["fused_update"]["flops"]
    assert abs(tf - jwork) <= 0.10 * jwork, (tf, jwork)


def test_executor_and_serving_bucket_programs():
    sym = mxt.sym.FullyConnected(mxt.sym.Variable("data"), num_hidden=4,
                                 name="fc")
    exe = sym.simple_bind(CPU, data=(2, 6))
    exe.forward(is_train=False, data=torch.ones(2, 6))
    progs = introspect.programs()
    assert progs["executor:fwd"]["by_kind"]["matmul"] == 2 * 2 * 6 * 4
    exe.forward(is_train=True, data=torch.ones(2, 6))
    exe.backward(torch.ones(2, 4))
    fb = introspect.programs()["executor:fwd_bwd"]
    assert fb["by_kind"]["matmul"] == 3 * 2 * 2 * 6 * 4
    pred = mxt.serving.BucketedPredictor(sym, {}, {"data": (8, 6)},
                                         dev=CPU)
    pred.warmup()
    buckets = [k for k in introspect.programs()
               if k.startswith("serve_bucket:")]
    assert len(buckets) == pred.num_compiled
    assert all(introspect.programs()[k]["flops"] > 0 for k in buckets)


def test_counting_runs_once_per_configuration(monkeypatch):
    st = _whole(mxt, monkeypatch, steps=4)
    assert introspect.programs()["whole_step"]["captures"] == 1
    x, y = _data(shape=(4, 16))
    st.step(_arr(mxt, x), _arr(mxt, y))
    rec = introspect.programs()["whole_step"]
    assert rec["captures"] == 2
    assert len(rec["signature"]) == 16


def test_dump_hlo_and_parse_round_trip(tmp_path, monkeypatch):
    introspect.configure(hlo=True)
    _whole(mxt, monkeypatch, steps=2)
    path = introspect.dump_hlo("whole_step", str(tmp_path))
    with open(path) as f:
        text = f.read()
    assert text.startswith("op\tshapes\tflops\tbytes\tscope\tkind\tcalls")
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    by = introspect.parse_hlo_flops(text)
    assert abs(sum(by.values())
               - introspect.programs()["whole_step"]["flops"]) < 1.0
    introspect.configure(hlo=False)
    introspect.note_program("bare", counted={"flops": 1.0, "bytes": 2.0})
    with pytest.raises(mxt.base.MXNetError, match="no HLO captured"):
        introspect.dump_hlo("bare", str(tmp_path))


# -- MFU ---------------------------------------------------------------------

def test_mfu_math_with_injected_peak(monkeypatch):
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "1e9")
    introspect.note_program("whole_step",
                            counted={"flops": 1e6, "bytes": 2e6})
    _warm("whole_step", 0.01)
    out = introspect.mfu()
    assert out["peak_source"] == "MXNET_PEAK_FLOPS"
    assert out["flops_per_step"] == 1e6
    assert abs(out["flops_per_s"] - 1e8) < 1e4
    assert abs(out["mfu_pct"] - 10.0) < 0.01
    assert abs(out["arithmetic_intensity"] - 0.5) < 1e-6
    assert abs(out["bytes_per_s"] - 2e8) < 2e4
    assert out["step_time_source"] == "host"
    assert abs(m.MFU.get() - 0.1) < 1e-4
    assert m.STEP_FLOPS_PER_S.get() > 0


def test_mfu_divides_by_the_cards_step_time(monkeypatch):
    """Device times (the CUDA event pairs around replays) win over the
    host span, which on the card times the replay call only; goodput
    books them as compute in place of the deferred host span."""
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "1e9")
    introspect.note_program("whole_step", counted={"flops": 1e6})
    _warm("whole_step", 0.001)             # the host's enqueue
    for _ in range(6):
        assert goodput.defer_span("whole_step")
        flight.record("whole_step", "step", 0.0, 1000.0)
        introspect._note_device("whole_step", 0.05, book=True)
    out = introspect.mfu()
    assert out["step_time_source"] == "device"
    assert abs(out["step_time_ms"] - 50.0) < 1e-6
    assert abs(out["mfu"] - 0.02) < 1e-6
    rep = goodput.report()
    assert abs(rep["classes"]["compute"]["seconds"] - 0.3) < 1e-9
    assert rep["classes"]["compute"]["events"] == 6


def test_fused_mfu_needs_explicit_step_time():
    for n in introspect.FUSED_STEP_PROGRAMS:
        introspect.note_program(n, counted={"flops": 1e6})
    _warm("trainer_step", 0.001)
    assert introspect.mfu() == {}
    assert introspect.phase_flops_map() == {}
    out = introspect.mfu(step_time_s=0.01)
    assert out and out["flops_per_step"] == 3e6


def test_mfu_empty_until_measurable():
    assert introspect.mfu() == {}
    introspect.note_program("whole_step", counted={"flops": 1.0})
    assert introspect.mfu() == {}
    assert m.MFU.get() == 0.0


def test_peak_table_and_override(monkeypatch):
    peak, src = introspect.peak_flops()
    assert (peak, src) == (introspect._CPU_NOMINAL_PEAK, "nominal-cpu")
    monkeypatch.setenv("MXNET_PEAK_FLOPS", "123.5e12")
    assert introspect.peak_flops() == (123.5e12, "MXNET_PEAK_FLOPS")
    monkeypatch.delenv("MXNET_PEAK_FLOPS")
    cases = [("NVIDIA H100 80GB HBM3", "bfloat16", False, 989.4e12),
             ("NVIDIA H100 80GB HBM3", "float32", False, 66.9e12),
             ("NVIDIA H100 80GB HBM3", "float32", True, 494.7e12),
             ("NVIDIA H100 PCIe", "bfloat16", False, 756e12),
             ("NVIDIA H100 PCIe", "float32", False, 51.2e12)]
    for name, dtype, tf32, want in cases:
        monkeypatch.setattr(introspect, "_device_name", lambda n=name: n)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
        assert introspect.peak_flops(dtype)[0] == want, (name, dtype)


def test_flops_counter_track_in_the_flight_dump(tmp_path, monkeypatch):
    _whole(mxt, monkeypatch, steps=3)
    path = flight.dump(str(tmp_path / "t.json"))
    with open(path) as f:
        trace = json.load(f)
    counters = [e for e in trace["traceEvents"]
                if e.get("name") == "mxnet_flops_per_s"]
    assert counters and all(e["ph"] == "C" and e["args"]["flops_per_s"] > 0
                            for e in counters)


# -- dispatch gauges ---------------------------------------------------------

def test_dispatch_gauges_match_jax(monkeypatch):
    _whole(mxj, monkeypatch)
    _whole(mxt, monkeypatch)
    assert m.TRAINER_STEP_DISPATCHES.get() == \
        jm.TRAINER_STEP_DISPATCHES.get() == 1.0
    monkeypatch.setenv("MXNET_WHOLE_STEP", "0")
    _fused(mxj)
    _fused(mxt)
    assert m.TRAINER_STEP_DISPATCHES.get() == \
        jm.TRAINER_STEP_DISPATCHES.get() == 2.0
    monkeypatch.setenv("MXNET_WHOLE_STEP", "1")
    from mxnet_tpu.autotune import SuperStepCompiler as JSuper
    from mxnet_tpu_torch.autotune import SuperStepCompiler
    x, y = _data()
    for mx, cls in ((mxj, JSuper), (mxt, SuperStepCompiler)):
        net = _mlp(mx)
        sst = cls(net, mx.gluon.loss.L2Loss(), _trainer(mx, net), k=2)
        for _ in range(2):
            sst.superstep([_arr(mx, x)] * 2, [_arr(mx, y)] * 2)
    assert m.SUPERSTEP_DISPATCHES.get() == \
        jm.SUPERSTEP_DISPATCHES.get() == 1.0
    assert m.TRAINER_STEP_DISPATCHES.get() == 0.5
    snap = mxt.observability.snapshot()
    assert snap["superstep_dispatches"] == 1.0
    assert {"enabled", "hlo", "programs", "mfu", "sentinel",
            "known_scopes"} <= set(snap["programs"])


# -- the perf-regression sentinel --------------------------------------------

def _arm(tmp_path, monkeypatch, p50_s=0.01):
    monkeypatch.setenv("MXNET_PERF_BASELINE_DIR", str(tmp_path))
    _warm("whole_step", p50_s)
    introspect.sentinel_tick("whole_step")
    path = introspect.baseline_path("whole_step")
    assert path and os.path.exists(path)
    return path


def _fires():
    return m.PERF_REGRESSIONS.get(kind="step_time", phase="whole_step")


def test_sentinel_baseline_written_atomically(tmp_path, monkeypatch):
    path = _arm(tmp_path, monkeypatch)
    with open(path) as f:
        base = json.load(f)
    assert abs(base["step_time_p50_ms"] - 10.0) < 0.5
    assert base["phase"] == "whole_step" and base["platform"] == "cpu"
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    introspect.sentinel_tick("whole_step")
    assert introspect.sentinel_armed()
    assert not introspect.regression_active()


def test_sentinel_fires_exactly_once_on_2x(tmp_path, monkeypatch):
    _arm(tmp_path, monkeypatch)
    before = _fires()
    flight.reset()
    _warm("whole_step", 0.02)
    for _ in range(5):
        introspect.sentinel_tick("whole_step")
    assert introspect.regression_active()
    assert _fires() - before == 1.0
    ph = introspect.sentinel_state()["phases"]["whole_step"]
    assert ph["active"] and ph["kind"] == "step_time"


def test_sentinel_deferred_fire_after_rate_window(tmp_path, monkeypatch):
    _arm(tmp_path, monkeypatch)
    before = _fires()
    for p50, active, fired in ((0.02, True, 1.0), (0.01, False, 1.0),
                               (0.03, True, 1.0)):
        flight.reset()
        _warm("whole_step", p50)
        introspect.sentinel_tick("whole_step")
        assert introspect.regression_active() is active
        assert _fires() - before == fired
    introspect.configure(regression_min_s=0.0)
    introspect.sentinel_tick("whole_step")
    assert _fires() - before == 2.0
    introspect.sentinel_tick("whole_step")
    assert _fires() - before == 2.0


def test_sentinel_reloads_on_signature_change(tmp_path, monkeypatch):
    introspect.note_program("whole_step", counted={"flops": 1.0},
                            signature="sigA")
    _arm(tmp_path, monkeypatch)
    assert "sigA" in introspect.baseline_path("whole_step")
    introspect.note_program("whole_step", counted={"flops": 1.0},
                            signature="sigB")
    flight.reset()
    _warm("whole_step", 0.03)
    introspect.sentinel_tick("whole_step")
    assert not introspect.regression_active()
    path = introspect.baseline_path("whole_step")
    assert "sigB" in path
    with open(path) as f:
        assert abs(json.load(f)["step_time_p50_ms"] - 30.0) < 2.0


def test_sentinel_clears_when_back_under(tmp_path, monkeypatch):
    _arm(tmp_path, monkeypatch)
    for p50, active in ((0.02, True), (0.01, False)):
        flight.reset()
        _warm("whole_step", p50)
        introspect.sentinel_tick("whole_step")
        assert introspect.regression_active() is active


def test_sentinel_corrupt_baseline_rejected(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("MXNET_PERF_BASELINE_DIR", str(tmp_path))
    _warm("whole_step", 0.01)
    path = introspect.baseline_path("whole_step")
    with open(path, "w") as f:
        f.write("{not json")
    with caplog.at_level(
            logging.WARNING,
            logger="mxnet_tpu_torch.observability.introspect"):
        introspect.sentinel_tick("whole_step")
    assert any("corrupt" in r.message for r in caplog.records)
    assert not introspect.sentinel_armed()
    with open(path) as f:
        assert f.read() == "{not json"
    assert introspect.refresh_baseline("whole_step") is not None
    with open(path) as f:
        assert json.load(f)["phase"] == "whole_step"
    assert introspect.sentinel_armed()


def test_sentinel_flips_readyz_and_refresh_clears(tmp_path, monkeypatch):
    _arm(tmp_path, monkeypatch)
    flight.reset()
    _warm("whole_step", 0.025)
    introspect.sentinel_tick("whole_step")
    assert introspect.regression_active()
    sym = mxt.sym.FullyConnected(mxt.sym.Variable("data"), num_hidden=4,
                                 name="fc")
    pred = mxt.serving.BucketedPredictor(sym, {}, {"data": (4, 3)},
                                         dev=CPU).warmup()
    with mxt.serving.ResilientServer(pred) as srv:
        rz = srv.readyz()
        assert rz["checks"]["perf_regression"] is False
        assert "perf_regression" in rz["reasons"]
        assert rz["detail"]["perf_sentinel"]["whole_step"]["kind"] == \
            "step_time"
        introspect.refresh_baseline("whole_step")
        assert srv.readyz()["checks"]["perf_regression"] is True


def test_sentinel_disarmed_without_dir_and_dir_default(tmp_path,
                                                       monkeypatch):
    _warm("whole_step", 0.01)
    introspect.sentinel_tick("whole_step")
    assert introspect.baseline_dir() is None
    assert not introspect.sentinel_armed()
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path))
    assert introspect.baseline_dir() == \
        jint.baseline_dir() == os.path.join(str(tmp_path), "perf-baselines")
    monkeypatch.setenv("MXNET_PERF_BASELINE_DIR", str(tmp_path / "own"))
    assert introspect.baseline_dir() == str(tmp_path / "own")


def test_disabled_is_one_boolean_noop(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_PERF_BASELINE_DIR", str(tmp_path))
    introspect.disable()
    try:
        assert introspect.note_program("x", counted={"flops": 1.0}) == {}
        assert introspect.note_jit("y", None) == {}
        with introspect.layer_scope("must_not_register"):
            pass
        assert "must_not_register" not in introspect.known_scopes()
        _warm("whole_step", 0.01)
        introspect.sentinel_tick("whole_step")
        assert not os.listdir(tmp_path)
        assert introspect.refresh_baseline("whole_step") is None
        _whole(mxt, monkeypatch, steps=2)
        assert introspect.programs() == {}
        snap = mxt.observability.snapshot()["programs"]
        assert snap["enabled"] is False and snap["programs"] == {}
    finally:
        introspect.enable()
