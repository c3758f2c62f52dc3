"""``gluon.data`` and ``metric`` of the port against the JAX package.

The same arrays go through both packages' ``ArrayDataset``, samplers and
``DataLoader`` (``last_batch`` keep, discard and rollover; ``shuffle``
under the same numpy seed) and through ``metric.Accuracy``,
``TopKAccuracy``, ``CrossEntropy``, ``create`` and the others; the port
runs on the CPU (``with mx.cpu():``) and must give the same batches and
the same metric values.
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt


def _np(x):
    return x.asnumpy() if isinstance(x, mxj.nd.NDArray) else \
        mxt.nd.asnumpy(x)


def _batches(mx, loader_kwargs, epochs=1, seed=None):
    data = np.arange(30, dtype=np.float32).reshape(10, 3)
    label = np.arange(10, dtype=np.float32)
    dataset = mx.gluon.data.ArrayDataset(data, label)
    loader = mx.gluon.data.DataLoader(dataset, **loader_kwargs)
    if seed is not None:
        np.random.seed(seed)
    out = []
    with mx.cpu():
        for _ in range(epochs):
            out.append(len(loader))
            for x, y in loader:
                out.append((_np(x), _np(y)))
    return out


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=4), dict(batch_size=4, last_batch="discard"),
    dict(batch_size=4, last_batch="rollover"),
    dict(batch_size=3, shuffle=True), dict(batch_size=4, num_workers=2)],
    ids=["keep", "discard", "rollover", "shuffle", "workers"])
def test_dataloader_matches_jax(kwargs):
    seed = 11 if kwargs.get("shuffle") else None
    want = _batches(mxj, kwargs, epochs=2, seed=seed)
    got = _batches(mxt, kwargs, epochs=2, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, int):
            assert g == w
        else:
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_datasets_and_samplers_match_jax():
    rs = np.random.RandomState(0)
    a, b = rs.normal(size=(6, 2)).astype(np.float32), np.arange(6)
    for mx in (mxj, mxt):
        data = mx.gluon.data
        ds = data.ArrayDataset(a, b)
        assert len(ds) == 6
        np.testing.assert_array_equal(ds[2][0], a[2])
        assert ds[2][1] == 2
        simple = data.SimpleDataset(list(range(5))).transform(lambda v: v * 2)
        assert [simple[i] for i in range(5)] == [0, 2, 4, 6, 8]
        first = ds.transform_first(lambda v: v + 1)
        np.testing.assert_array_equal(first[1][0], a[1] + 1)
        batch = data.BatchSampler(data.SequentialSampler(7), 3, "keep")
        assert list(batch) == [[0, 1, 2], [3, 4, 5], [6]]
        roll = data.BatchSampler(data.SequentialSampler(7), 3, "rollover")
        assert list(roll) == [[0, 1, 2], [3, 4, 5]]
        assert list(roll) == [[6, 0, 1], [2, 3, 4]]
        np.random.seed(3)
        shuffled = list(data.RandomSampler(8))
        if mx is mxj:
            want = shuffled
    assert shuffled == want


def _metric_values(mx):
    rs = np.random.RandomState(1)
    pred = rs.uniform(size=(8, 5)).astype(np.float32)
    pred /= pred.sum(axis=1, keepdims=True)
    label = rs.randint(0, 5, 8).astype(np.float32)
    with mx.cpu():
        p, l = mx.nd.array(pred), mx.nd.array(label)
    metrics = [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=3),
               mx.metric.CrossEntropy(), mx.metric.create("acc"),
               mx.metric.create(["acc", "crossentropy"]), mx.metric.Perplexity(),
               mx.metric.MAE(), mx.metric.MSE(), mx.metric.RMSE(),
               mx.metric.Loss(), mx.metric.create("top_k_accuracy", top_k=2),
               mx.metric.np(lambda lab, prd: float(np.abs(prd).sum()))]
    out = []
    for m in metrics:
        if isinstance(m, (mx.metric.MAE, mx.metric.MSE, mx.metric.RMSE)):
            m.update([l], [p[:, 0]])
        else:
            m.update([l], [p])
        m.update([l[:4]], [p[:4]]) if not isinstance(
            m, (mx.metric.MAE, mx.metric.MSE, mx.metric.RMSE)) else None
        out.append(m.get())
        m.reset()
        out.append(m.get_name_value())
    return out


def test_metrics_match_jax():
    want = _metric_values(mxj)
    got = _metric_values(mxt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple) and not isinstance(w[0], list):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1], w[1], rtol=1e-6)
        else:
            assert str(g) == str(w)
