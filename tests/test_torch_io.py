"""The port's data iterators against the JAX package's, on the CPU.

The same numpy arrays and files go through ``mxnet_tpu.io`` and
``mxnet_tpu_torch.io``: every batch's data, label and pad, and the
``provide_data``/``provide_label`` descriptions, must be equal, exactly.
``NDArrayIter`` under each ``last_batch_handle`` with and without
``shuffle`` (numpy's global RNG, seeded alike), over two epochs; a tensor
source gives the batches of its numpy twin, sliced where it lies;
``ResizeIter``, ``PrefetchingIter``, ``CSVIter`` and ``MNISTIter`` over
idx files written here.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

_RS = np.random.RandomState(11)
_DATA = _RS.normal(size=(10, 3, 2)).astype(np.float32)
_LABEL = np.arange(10, dtype=np.float32)


def _np(x):
    return x.asnumpy() if isinstance(x, mxj.nd.NDArray) else \
        mxt.nd.asnumpy(x)


def _batches(it, epochs=2):
    """Every batch of ``epochs`` epochs: (data, label, pad)."""
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([_np(d) for d in b.data],
                        [_np(l) for l in b.label or []], b.pad))
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _descs(descs):
    return [(d.name, tuple(d.shape), np.dtype(d.dtype).name) for d in descs]


def _both(make, epochs=2, seed=5):
    res = []
    for mx in (mxj, mxt):
        np.random.seed(seed)
        it = make(mx)
        res.append((_batches(it, epochs), _descs(it.provide_data),
                    _descs(it.provide_label)))
    return res


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "shuffled"])
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle, shuffle):
    (want, wd, wl), (got, gd, gl) = _both(
        lambda mx: mx.io.NDArrayIter(_DATA, _LABEL, batch_size=4,
                                     shuffle=shuffle,
                                     last_batch_handle=handle), epochs=3)
    _same(got, want)
    assert gd == wd == [("data", (4, 3, 2), "float32")]
    assert gl == wl == [("softmax_label", (4,), "float32")]


def test_ndarray_iter_dict_sources_match_jax():
    data = {"a": _DATA, "b": _DATA[:, 0]}
    (want, wd, wl), (got, gd, gl) = _both(
        lambda mx: mx.io.NDArrayIter(data, None, batch_size=3))
    _same(got, want)
    assert gd == wd and gl == wl == []


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "shuffled"])
def test_tensor_source_is_sliced_where_it_lies(shuffle):
    """A tensor source gives its numpy twin's batches; an ordered batch is
    a view of it, a shuffled one a gather on its device."""
    def make(src_x, src_y):
        np.random.seed(2)
        return mxt.io.NDArrayIter(src_x, src_y, batch_size=4,
                                  shuffle=shuffle)
    x, y = torch.from_numpy(_DATA.copy()), torch.from_numpy(_LABEL.copy())
    tensor_it = make(x, y)
    _same(_batches(tensor_it), _batches(make(_DATA, _LABEL)))
    first = next(iter(tensor_it)).data[0]
    assert first.device == x.device
    assert (first.untyped_storage().data_ptr() ==
            x.untyped_storage().data_ptr()) == (not shuffle)


def test_resize_iter_matches_jax():
    (want, *_), (got, *_) = _both(
        lambda mx: mx.io.ResizeIter(
            mx.io.NDArrayIter(_DATA, _LABEL, batch_size=4), 5))
    _same(got, want)
    assert len(got) == 10


def test_prefetching_iter_matches_jax():
    """The batches of the wrapped iterator in order, over two epochs, and
    its descriptions renamed."""
    rename = [{"data": "x"}]
    (want, wd, _), (got, gd, _) = _both(
        lambda mx: mx.io.PrefetchingIter(
            mx.io.NDArrayIter(_DATA, _LABEL, batch_size=4, shuffle=True),
            rename_data=rename))
    _same(got, want)
    assert gd == wd == [("x", (4, 3, 2), "float32")]


def test_prefetching_iter_raises_what_its_source_raises():
    class Broken(mxt.io.DataIter):
        provide_data = provide_label = []

        def next(self):
            raise ValueError("bad record")

    it = mxt.io.PrefetchingIter(Broken(2))
    with pytest.raises(ValueError, match="bad record"):
        it.next()
    with pytest.raises(StopIteration):
        it.next()


def test_csv_iter_matches_jax(tmp_path):
    np.savetxt(tmp_path / "d.csv", _DATA.reshape(10, -1), delimiter=",")
    np.savetxt(tmp_path / "l.csv", _LABEL, delimiter=",")
    for round_batch in (True, False):
        (want, wd, wl), (got, gd, gl) = _both(
            lambda mx: mx.io.CSVIter(str(tmp_path / "d.csv"), (3, 2),
                                     label_csv=str(tmp_path / "l.csv"),
                                     batch_size=4, round_batch=round_batch))
        _same(got, want)
        assert gd == wd and gl == wl


def _write_idx(path, arr):
    """An idx file (MNIST's format: big-endian dims, uint8 payload)."""
    head = struct.pack(">HBB", 0, 8, arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("flat", [False, True], ids=["images", "flat"])
def test_mnist_iter_matches_jax(tmp_path, flat):
    rs = np.random.RandomState(4)
    _write_idx(tmp_path / "img.gz", rs.randint(0, 256, (20, 28, 28)))
    _write_idx(tmp_path / "lab", rs.randint(0, 10, (20,)))
    (want, wd, wl), (got, gd, gl) = _both(
        lambda mx: mx.io.MNISTIter(image=str(tmp_path / "img.gz"),
                                   label=str(tmp_path / "lab"),
                                   batch_size=8, flat=flat))
    _same(got, want)
    assert len(got) == 4                 # 20 samples: the last 4 discarded
    assert gd == wd and gl == wl
