"""The port's 2-bit gradient compression and gradient buckets against the
JAX package's, on the CPU.

The same numpy inputs go through ``mxnet_tpu.kvstore`` (its quantizer,
the compressed bucket reduce, ``GradBucketer`` and the store's per-key
compressed push) and ``mxnet_tpu_torch.kvstore``.  The packed bytes, the
dequantized values and the error-feedback residuals are compared exactly:
the quantizer is a comparison and a subtraction in float32 in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import kvstore as jkv
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.base import MXNetError

CPU = mxt.cpu()


def _arrays(n, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n) * scale).astype("f"), \
        (rs.randn(n) * 0.3).astype("f")


@pytest.mark.parametrize("n,threshold", [(1, 0.5), (7, 0.25), (64, 0.5),
                                         (1001, 0.25)])
def test_quantize_2bit_matches_jax(n, threshold):
    """Packed codes (four per byte) and the new residual, bitwise; the
    dequantized values too."""
    g, r = _arrays(n, n)
    jp, jr = jkv._quantize_2bit_impl(jnp.asarray(g), jnp.asarray(r),
                                     threshold)
    tp, tr = tkv.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r),
                               threshold)
    assert tp.dtype == torch.uint8 and tp.shape == ((n + 3) // 4,)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jd = jkv._dequantize_2bit_impl(jp, threshold, n)
    td = tkv.dequantize_2bit(tp, threshold, n)
    np.testing.assert_array_equal(td.numpy(),
                                  np.asarray(jd).astype(np.float32))


def test_compressed_bucket_reduce_matches_jax():
    """``reduce_buckets_inline`` over two buckets: reduced values and new
    residuals."""
    flats = [_arrays(n, 10 + n, scale=0.6) for n in (37, 256)]
    jout, jres, _ = jkv.reduce_buckets_inline(
        [jnp.asarray(g) for g, _ in flats],
        [jnp.asarray(r) for _, r in flats], 0.5)
    tout, tres = tkv.reduce_buckets_inline(
        [torch.from_numpy(g) for g, _ in flats],
        [torch.from_numpy(r) for _, r in flats], 0.5)
    for a, b in zip(tout + tres, list(jout) + list(jres)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_store_allreduce_with_compression_matches_jax():
    """``KVStore.allreduce(buckets, compression=, residuals=)`` over two
    rounds, the residuals carried: reduced buckets and residuals."""
    bufs = [_arrays(n, 20 + n, scale=0.4)[0] for n in (9, 40)]
    comp = {"type": "2bit", "threshold": 0.5}
    jstore, tstore = jkv.create("tpu_sync"), tkv.create("tpu_sync")
    jres = tres = None
    for rnd in range(2):
        vals = [b * (rnd + 1) for b in bufs]
        jred, jres = jstore.allreduce([mxj.nd.array(v) for v in vals],
                                      compression=comp, residuals=jres)
        tred, tres = tstore.allreduce([torch.from_numpy(v) for v in vals],
                                      compression=comp, residuals=tres)
        for a, b in zip(tred + tres, [x.asnumpy() for x in jred]
                        + [np.asarray(x) for x in jres]):
            np.testing.assert_array_equal(a.numpy(), b)


def test_per_key_compressed_push_matches_jax():
    """A store with compression set: each push quantizes the key's value
    against its residual; the pulled values and the residuals."""
    comp = {"type": "2bit", "threshold": 0.5}
    stores = {}
    for mx in (mxj, mxt):
        kv = mx.kv.create("device")
        kv.set_gradient_compression(comp)
        kv.init(3, mx.nd.zeros((5, 4), **({} if mx is mxj else
                                          {"ctx": CPU})))
        stores[mx] = kv
    rs = np.random.RandomState(4)
    for _ in range(3):
        v = (rs.randn(5, 4) * 0.4).astype("f")
        outs = {}
        for mx, kv in stores.items():
            arr = mx.nd.array(v) if mx is mxj else mx.nd.array(v, ctx=CPU)
            kv.push(3, arr)
            out = mx.nd.zeros((5, 4)) if mx is mxj else \
                mx.nd.zeros((5, 4), ctx=CPU)
            kv.pull(3, out=out)
            outs[mx] = out.asnumpy() if mx is mxj else out.numpy()
        np.testing.assert_array_equal(outs[mxt], outs[mxj])
        np.testing.assert_array_equal(
            stores[mxt]._residuals[3].numpy(),
            np.asarray(stores[mxj]._residuals[3]))


@pytest.mark.parametrize("params,store", [
    ({"type": "2bit", "threshold": 0.5}, "local"),
    ({"threshold": 0.5}, "device"),
    ({"type": "1bit"}, "device"),
    ({"type": "2bit", "threshold": 0.0}, "device"),
    ({"type": "2bit", "thresh": 0.5}, "device"),
], ids=["local store", "no type", "unknown type", "threshold 0",
        "unknown key"])
def test_set_gradient_compression_refuses_as_jax(params, store):
    for mx, err in ((mxj, mxj.base.MXNetError), (mxt, MXNetError)):
        with pytest.raises(err):
            mx.kv.create(store).set_gradient_compression(params)


_SIG = (((64, 32), "float32"), ((64,), "float32"), ((32, 64), "float32"),
        ((32,), "float32"), ((10, 32), "bfloat16"), ((10,), "bfloat16"),
        ((), "float32"), ((7, 3, 3, 3), "float32"))


@pytest.mark.parametrize("cap", [32 * 1024 * 1024, 1000, 8192, 1])
def test_bucket_layout_matches_jax(cap):
    """Buckets, each gradient's (bucket, offset, shape) and the bucket
    sizes, for caps from one bucket to one gradient per bucket, across a
    dtype change and a 0-d gradient."""
    jb, tb = jkv.GradBucketer(_SIG, cap), tkv.GradBucketer(_SIG, cap)
    assert tb.layout == jb.layout
    assert tb.sizes == jb.sizes
    assert [tuple(v) for v in tb.views] == [tuple(v) for v in jb.views]
    grads = [torch.from_numpy(np.asarray(np.random.RandomState(i).randn(
        *s), dtype="f")).to(getattr(torch, d))
        for i, (s, d) in enumerate(_SIG)]
    back = tb.unflatten(tb.flatten(grads))
    assert all(torch.equal(a, b) for a, b in zip(back, grads))


def test_trainer_bucket_size_env_matches_jax(monkeypatch):
    """``MXNET_BUCKET_SIZE_MB=0.001`` through each Trainer's bucketer on the
    same dense net: the same layout."""
    monkeypatch.setenv("MXNET_BUCKET_SIZE_MB", "0.001")
    layouts = {}
    for mx in (mxj, mxt):
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(32, in_units=8))
            net.add(mx.gluon.nn.Dense(4, in_units=32))
        net.initialize(ctx=CPU if mx is mxt else mxj.cpu())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              kvstore="tpu_sync", update_on_kvstore=False)
        sig = tuple((tuple(p.shape), "float32")
                    for p in net.collect_params().values())
        bk = tr._ensure_bucketer(sig, tuple(range(len(sig))))
        layouts[mx] = (bk.cap, bk.layout, bk.sizes)
    assert layouts[mxt] == layouts[mxj]
    assert layouts[mxt][0] == 1048 and len(layouts[mxt][1]) == 2


def test_fused_trainer_reduces_buckets_and_keeps_residuals():
    """With a store that reduces, ``Trainer.step`` reduces flat buckets:
    the same weights as the per-key path (``MXNET_FUSED_TRAINER=0``) over
    three compressed steps, the bucket residuals equal to the per-key
    residuals laid end to end."""
    rs = np.random.RandomState(5)
    x = rs.randn(6, 5).astype("f")
    out = {}
    for fused in (True, False):
        mxt.random.seed(2)
        net = mxt.gluon.nn.Dense(3, in_units=5)
        net.initialize(ctx=CPU)
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5},
                               kvstore="tpu_sync", update_on_kvstore=False,
                               compression_params={"type": "2bit",
                                                   "threshold": 0.05})
        tr._fused = fused
        for i in range(3):
            with mxt.autograd.record():
                loss = (net(mxt.nd.array(x * (i + 1), ctx=CPU)) ** 2).sum()
            loss.backward()
            tr.step(6)
        res = torch.cat(tr._residuals) if fused else torch.cat(
            [tr._kv._residuals[i] for i in range(2)])
        out[fused] = ([p.data().detach().clone()
                       for p in net.collect_params().values()], res)
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[True][1], out[False][1])


def test_residuals_of_another_bucket_layout_raise(tmp_path):
    """A state file's bucket residuals load only into the bucket layout
    they were saved for; another raises ``MXNetError`` when the bucketer
    is built, and nothing is silently reset."""
    def trained(units):
        net = mxt.gluon.nn.Dense(units, in_units=5)
        net.initialize(ctx=CPU)
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               kvstore="tpu_sync", update_on_kvstore=False,
                               compression_params={"type": "2bit"})
        with mxt.autograd.record():
            loss = net(mxt.nd.ones((2, 5), ctx=CPU)).sum()
        loss.backward()
        tr.step(2)
        return tr
    fname = str(tmp_path / "t.states")
    trained(3).save_states(fname)
    other = trained(4)
    with pytest.raises(MXNetError, match="different parameter/bucket"):
        other.load_states(fname)
