"""Package rules of the port: it stands alone, defaults to the GPU, and
never runs on the CPU unless asked to."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mxnet_tpu_torch")


def test_imports_with_jax_and_mxnet_tpu_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['mxnet_tpu'] = None; "
            "import mxnet_tpu_torch as mx; "
            "import mxnet_tpu_torch.recordio, mxnet_tpu_torch.image, "
            "mxnet_tpu_torch.detection, mxnet_tpu_torch._native; "
            "import mxnet_tpu_torch.analysis.sanitizer, "
            "mxnet_tpu_torch.observability.tracing, "
            "mxnet_tpu_torch.observability.journal, "
            "mxnet_tpu_torch.observability.goodput, "
            "mxnet_tpu_torch.observability.flight, "
            "mxnet_tpu_torch.observability.timeline, "
            "mxnet_tpu_torch.observability.memory, "
            "mxnet_tpu_torch.observability.report, "
            "mxnet_tpu_torch.profiler, mxnet_tpu_torch.resilience, "
            "mxnet_tpu_torch.faultinject, "
            "mxnet_tpu_torch.gluon.supervisor, "
            "mxnet_tpu_torch.gluon.data.prefetcher, "
            "mxnet_tpu_torch.observability.introspect, "
            "mxnet_tpu_torch.autotune.sweep, "
            "mxnet_tpu_torch.autotune.__main__, "
            "mxnet_tpu_torch.serving.decode, "
            "mxnet_tpu_torch.serving.registry, "
            "mxnet_tpu_torch.ops.sequence, mxnet_tpu_torch.ops.contrib, "
            "mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.rnn, "
            "mxnet_tpu_torch.contrib, "
            "mxnet_tpu_torch.module.bucketing_module; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'mxnet_tpu.')) "
            "for m in sys.modules if sys.modules[m] is not None); "
            "print(len(mx.nd.__dict__))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_FORBIDDEN = re.compile(
    r"import jax|from jax|\bmxnet_tpu\.|(from|import) mxnet_tpu\b")


def test_sources_never_name_jax_or_mxnet_tpu():
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, f)
                with open(path) as fh:
                    offenders += [f"{path}:{i}: {line.strip()}"
                                  for i, line in enumerate(fh, 1)
                                  if _FORBIDDEN.search(line)]
    assert offenders == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_gpu_is_the_default_and_raises_without_cuda(no_cuda):
    assert mxt.current_context() == mxt.Context("gpu", 0)
    with pytest.raises(MXNetError):
        mxt.gpu(0)
    with pytest.raises(MXNetError):
        mxt.nd.array([1.0, 2.0])
    with pytest.raises(MXNetError):
        mxt.nd.zeros((2, 2))
    net = TransformerLM(vocab=8, dim=16, num_layers=1, num_heads=2,
                        max_len=8, attn_type="flash")
    with pytest.raises(MXNetError):
        net.initialize()


def test_recurrent_entry_points_raise_without_cuda_or_cpu(no_cuda):
    """The recurrent surface defaults to ``gpu(0)`` as the rest does:
    without CUDA and without ``cpu()`` each entry point raises."""
    from mxnet_tpu_torch.serving.decode import CellModel, DecodeEngine
    x = np.zeros((3, 2, 4), np.float32)
    calls = [lambda: mxt.gluon.rnn.LSTM(5, input_size=4).initialize(),
             lambda: mxt.gluon.rnn.GRUCell(5, input_size=4).initialize(),
             lambda: mxt.nd.RNN(x, np.zeros(rnn_size, np.float32),
                                state_size=5, num_layers=1, mode="lstm")]
    rnn_size = mxt.ops.sequence.rnn_param_size(1, 4, 5, False, "lstm")
    stack = mxt.rnn.SequentialRNNCell()
    stack.add(mxt.rnn.LSTMCell(5, prefix="l0_"))
    out, _ = stack.unroll(3, mxt.sym.var("data"), merge_outputs=True)

    def bucketing():
        mod = mxt.mod.BucketingModule(
            lambda key: (out, ("data",), None), default_bucket_key=3)
        mod.bind([("data", (2, 3, 4))], for_training=False)
    calls += [lambda: mxt.mod.Module(out, label_names=None).bind(
                  [("data", (2, 3, 4))], for_training=False),
              bucketing,
              lambda: DecodeEngine(CellModel(stack, vocab=8), warmup=False)]
    for call in calls:
        with pytest.raises(MXNetError):
            call()


def test_explicit_cpu_runs(no_cuda):
    with mxt.cpu():
        x = mxt.nd.array([1.0, 2.0])
    assert x.device.type == "cpu"
    net = TransformerLM(vocab=8, dim=16, num_layers=1, num_heads=2,
                        max_len=8, attn_type="flash")
    net.initialize(ctx=mxt.cpu())
    out = net(mxt.nd.array(np.zeros((1, 4), np.float32), ctx=mxt.cpu()))
    assert out.shape == (1, 4, 8) and out.device.type == "cpu"


def _small_params():
    net = TransformerLM(vocab=8, dim=16, num_layers=1, num_heads=2,
                        max_len=8)
    net.initialize(ctx=mxt.cpu())
    net(mxt.nd.zeros((1, 4), ctx=mxt.cpu()))
    return {"lm7_" + n[len(net.prefix):]: mxt.nd.asnumpy(p.data())
            for n, p in net.collect_params().items()}


def _fresh():
    net = TransformerLM(vocab=8, dim=16, num_layers=1, num_heads=2,
                        max_len=8)
    net.initialize(ctx=mxt.cpu())      # deferred: the data lands on the CPU
    return net


def test_convert_checks_names_and_shapes():
    params = _small_params()
    fresh = params_from_mxnet_tpu(params, _fresh())
    np.testing.assert_array_equal(
        mxt.nd.asnumpy(fresh.head.weight.data()), params["lm7_head_weight"])
    assert fresh.head.weight.data().device.type == "cpu"
    bad = [dict(params), dict(params), dict(params)]
    del bad[0]["lm7_head_bias"]
    bad[1]["lm7_extra_weight"] = np.zeros(3, np.float32)
    bad[2]["lm7_tok_weight"] = np.zeros((9, 16), np.float32)
    for b in bad:
        with pytest.raises(MXNetError):
            params_from_mxnet_tpu(b, _fresh())


def test_cast_keeps_ids_float32():
    """After cast('bfloat16') ids stay float32, so ids above 256 (not
    representable in bf16) still select their own rows."""
    net = TransformerLM(vocab=300, dim=16, num_layers=1, num_heads=2,
                        max_len=8, attn_type="flash")
    net.initialize(ctx=mxt.cpu())
    tokens = mxt.nd.array([[299.0, 257.0, 1.0]], ctx=mxt.cpu())
    net(tokens)
    net.cast("bfloat16")
    out = net(tokens)
    assert out.dtype == torch.bfloat16 and tokens.dtype == torch.float32
    weight = net.tok.weight.data()
    assert weight.dtype == torch.bfloat16
    assert dict(net.named_parameters())["tok.weight"] is weight
    rows = net.tok(tokens)[0]
    assert torch.equal(rows[0], weight[299]) and torch.equal(rows[1], weight[257])
