"""The port's prefetcher against the JAX package's, on the CPU.

``AsyncPrefetcher``, ``prefetch_to_device`` and
``io.PrefetchingIter(device=...)`` give the same batches in the same order
as the JAX prefetcher; a ``data.batch`` ``OSError`` respawns the worker
once and loses no batch; corrupt records are skipped within
``skip_budget`` and counted, and one more gives ``DataSkipBudgetError``,
with the same counts in both packages.  (The pinned staging and the side
stream of a CUDA destination run on the card: ``chip_smoke.py`` phase 16
(h).)
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import faultinject as jfi
from mxnet_tpu import resilience as jres
from mxnet_tpu.gluon.data.prefetcher import AsyncPrefetcher as JPrefetcher
from mxnet_tpu_torch import faultinject as tfi
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch.gluon.data.prefetcher import AsyncPrefetcher as TPrefetcher
from mxnet_tpu_torch.observability import metrics as TM

CPU = mxt.cpu()
PKG = {"jax": (mxj, jfi, jres, JPrefetcher), "torch": (mxt, tfi, tres,
                                                      TPrefetcher)}


@pytest.fixture(autouse=True)
def _no_plan():
    prev = (jfi.install(None), tfi.install(None))
    yield
    jfi.install(prev[0])
    tfi.install(prev[1])


def _drain(pf):
    out = []
    while True:
        try:
            out.append(pf.get())
        except StopIteration:
            return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_async_prefetcher_order_and_exhaustion_match_jax():
    got = {}
    for k, (_, _, _, P) in PKG.items():
        src = iter(range(10))
        pf = P(lambda: next(src), depth=3, transform=lambda v: v * 2)
        got[k] = _drain(pf)
        with pytest.raises(StopIteration):
            pf.get()
    assert got["torch"] == got["jax"] == [2 * i for i in range(10)]


def test_prefetch_to_device_batches_match_jax():
    rs = np.random.RandomState(0)
    X = rs.normal(0, 1, (20, 3)).astype("f")
    Y = rs.randint(0, 4, 20).astype("f")
    outs = {}
    for k, (mx, *_rest) in PKG.items():
        dev = CPU if mx is mxt else mxj.cpu()
        with dev:
            ds = mx.gluon.data.ArrayDataset(X, Y)
            # host batches: the prefetcher's worker does the device copy
            loader = mx.gluon.data.DataLoader(
                ds, batch_size=6,
                batchify_fn=lambda d: [np.stack(f) for f in zip(*d)])
            it = mx.gluon.data.prefetch_to_device(loader, depth=2,
                                                  device=dev)
            outs[k] = [(_np(x), _np(y)) for x, y in it]
            it.close()
    assert len(outs["torch"]) == len(outs["jax"]) == 4
    for (a, b), (c, d) in zip(outs["torch"], outs["jax"]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_prefetching_iter_device_matches_jax():
    rs = np.random.RandomState(1)
    X = rs.normal(0, 1, (10, 2)).astype("f")
    Y = rs.normal(0, 1, (10,)).astype("f")
    outs = {}
    for k, (mx, *_rest) in PKG.items():
        dev = CPU if mx is mxt else mxj.cpu()
        src = mx.io.NDArrayIter(X, Y, batch_size=4)
        it = mx.io.PrefetchingIter(src, device=dev, skip_budget=3)
        assert it._pf._skip_budget == 3
        outs[k] = [(_np(b.data[0]), _np(b.label[0])) for b in it]
        it.close()
    for (a, b), (c, d) in zip(outs["torch"], outs["jax"]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def _respawn(k):
    _, fi, _, P = PKG[k]
    src = iter(range(8))
    plan = fi.FaultPlan().add("data.batch", "raise", exc=OSError, times=1,
                              after=3)
    with fi.active(plan):
        pf = P(lambda: next(src))
        got = _drain(pf)
    return got, pf.respawns, plan.stats()


def test_transient_read_respawns_once_and_loses_no_batch():
    respawns = TM.PREFETCH_RESPAWNS.value
    got = _respawn("torch")
    assert got == _respawn("jax")
    assert got == (list(range(8)), 1, {"data.batch": 1})
    assert TM.PREFETCH_RESPAWNS.value == respawns + 1


def _skips(k, times, budget):
    _, fi, res, P = PKG[k]
    src = iter(range(10))
    plan = fi.FaultPlan().add("data.batch", "raise",
                              exc=res.DataCorruptionError, times=times,
                              after=2)
    err = None
    with fi.active(plan):
        pf = P(lambda: next(src), skip_budget=budget)
        got = []
        try:
            while True:
                got.append(pf.get())
        except StopIteration:
            pass
        except (res.DataSkipBudgetError, res.DataCorruptionError) as e:
            err = (type(e).__name__, type(e.__cause__).__name__)
    return got, pf.skipped, err


@pytest.mark.parametrize("times,budget", [(2, 4), (3, 2), (1, 0)])
def test_corrupt_records_skip_within_budget_as_jax(times, budget):
    skipped = TM.DATA_RECORDS_SKIPPED.value
    got = _skips("torch", times, budget)
    assert got == _skips("jax", times, budget)
    if times <= budget:
        assert got == (list(range(10)), times, None)
        assert TM.DATA_RECORDS_SKIPPED.value == skipped + times
    elif budget:
        assert got[1] == budget
        assert got[2] == ("DataSkipBudgetError", "DataCorruptionError")
    else:       # no budget: the corruption itself surfaces
        assert got == ([0, 1], 0, ("DataCorruptionError", "NoneType"))


def test_budget_zero_surfaces_the_corruption_itself():
    src = iter(range(5))

    def read():
        v = next(src)
        if v == 2:
            raise tres.DataCorruptionError("record 2 undecodable")
        return v
    pf = TPrefetcher(read, skip_budget=0)
    assert pf.get() == 0 and pf.get() == 1
    with pytest.raises(tres.DataCorruptionError):
        pf.get()
    with pytest.raises(StopIteration):
        pf.get()
