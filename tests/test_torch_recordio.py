"""The port's record-file input path against the JAX package's, on the CPU.

The same seeded numpy images, labels and files go through ``mxnet_tpu``
and ``mxnet_tpu_torch`` (``ctx=cpu()``).  Records, labels and uint8 data
must be equal bitwise; normalised float batches within 1e-4 absolute (the
same float32 arithmetic in both, so they are in fact equal).  Covered:
``.rec``/``.idx`` files either package writes and the other reads,
``pack``/``unpack`` with scalar and vector labels, every augmenter and
``CreateAugmenter`` under the same ``random``/``np.random`` seeds,
``ImageRecordIter`` on the host and with ``device_augment`` (``.npy``
payloads; a PNG case where PIL is installed), ``TensorRecordIter`` on the
native runtime (round trip, shuffle, pad, ``label_width``),
``ImageDetRecordIter`` and the ``Det*Aug`` boxes, and the record datasets.

The JAX package decodes ``.npy`` payloads only when neither cv2 nor PIL
imports (it tries them first), so its side runs with both hidden.
"""
import os
import random
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu._native
import mxnet_tpu_torch as mxt

CPU = mxt.cpu()
MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
            std_g=57.12, std_b=57.375)


def _np(x):
    if isinstance(x, torch.Tensor):
        return mxt.nd.asnumpy(x.float() if x.dtype == torch.bfloat16 else x)
    return x.asnumpy() if isinstance(x, mxj.nd.NDArray) else np.asarray(x)


def _seed(s):
    random.seed(s)
    np.random.seed(s)


@pytest.fixture
def no_decoders(monkeypatch):
    """cv2 and PIL hidden, as on a machine without them."""
    def hide():
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setitem(sys.modules, "PIL", None)
    return hide


def _images(n, hw, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (n,) + hw + (3,)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.float32)
    return imgs, labels


def _write_images(mx, path, imgs, labels, fmt=".npy"):
    rec = mx.recordio.MXIndexedRecordIO(str(path) + ".idx", str(path) + ".rec",
                                        "w")
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        rec.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(lab), i, 0), img, img_fmt=fmt))
    rec.close()
    return str(path) + ".rec"


# -- records -----------------------------------------------------------------
def _records():
    rs = np.random.RandomState(3)
    out = []
    for i in range(7):
        label = float(i) if i % 2 else rs.uniform(size=i % 4 + 2).astype(
            np.float32)
        out.append((mxj.recordio.IRHeader(0, label, i, 2 * i),
                    rs.bytes(int(rs.randint(0, 13)))))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_record_files_move_both_ways(tmp_path, writer):
    """Each package writes the same records; the files are byte-equal and
    the other package reads every record back, sequentially and by key."""
    files = {}
    for name, mx in (("jax", mxj), ("port", mxt)):
        w = mx.recordio.MXIndexedRecordIO(str(tmp_path / f"{name}.idx"),
                                          str(tmp_path / f"{name}.rec"), "w")
        for hdr, payload in _records():
            w.write_idx(hdr.id, mx.recordio.pack(hdr, payload))
        w.close()
        files[name] = [open(tmp_path / f"{name}.{ext}", "rb").read()
                       for ext in ("rec", "idx")]
    assert files["jax"] == files["port"]
    reader = mxt if writer == "jax" else mxj
    r = reader.recordio.MXIndexedRecordIO(str(tmp_path / f"{writer}.idx"),
                                          str(tmp_path / f"{writer}.rec"), "r")
    seq = reader.recordio.MXRecordIO(str(tmp_path / f"{writer}.rec"), "r")
    for hdr, payload in reversed(_records()):
        for buf in (r.read_idx(hdr.id),):
            got_hdr, got = reader.recordio.unpack(buf)
            assert got == payload and got_hdr.id == hdr.id
            np.testing.assert_array_equal(got_hdr.label, hdr.label)
    n = 0
    while seq.read() is not None:
        n += 1
    assert n == len(_records())


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]],
                         ids=["scalar", "vector"])
def test_pack_unpack_matches_jax(label):
    hdr = (0, label, 7, 9)
    want = mxj.recordio.pack(mxj.recordio.IRHeader(*hdr), b"payload")
    got = mxt.recordio.pack(mxt.recordio.IRHeader(*hdr), b"payload")
    assert got == want
    (jh, jp), (th, tp) = mxj.recordio.unpack(want), mxt.recordio.unpack(got)
    assert tp == jp == b"payload"
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(th.label, jh.label)


def test_image_payloads_decode_by_magic(tmp_path, no_decoders):
    """``.npy`` decodes without cv2 or PIL (BGR stored, RGB by
    ``imdecode``); an unknown payload, or a JPEG with no decoder, raises."""
    img = _images(1, (5, 6))[0][0]
    buf = mxt.recordio.pack_img((0, 1.0, 0, 0), img, img_fmt=".npy")
    assert buf == mxj.recordio.pack_img((0, 1.0, 0, 0), img, img_fmt=".npy")
    hdr, dec = mxt.recordio.unpack_img(buf)
    np.testing.assert_array_equal(dec, img)
    np.testing.assert_array_equal(
        mxt.image.imdecode_np(mxt.recordio.unpack(buf)[1]), img[:, :, ::-1])
    no_decoders()
    for payload in (b"not an image", b"\xff\xd8\xff\xe0rest"):
        with pytest.raises(mxt.MXNetError):
            mxt.image.imdecode_np(payload)


# -- augmenters ----------------------------------------------------------------
def _augs(mx):
    img = mx.image
    eig = np.array([55.46, 4.794, 1.148])
    vec = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                    [-0.5836, -0.6948, 0.4203]])
    return {
        "ResizeAug": img.ResizeAug(10),
        "ForceResizeAug": img.ForceResizeAug((9, 7)),
        "RandomCropAug": img.RandomCropAug((8, 6)),
        "CenterCropAug": img.CenterCropAug((8, 6)),
        "HorizontalFlipAug": img.HorizontalFlipAug(0.5),
        "CastAug": img.CastAug(),
        "BrightnessJitterAug": img.BrightnessJitterAug(0.3),
        "ContrastJitterAug": img.ContrastJitterAug(0.3),
        "SaturationJitterAug": img.SaturationJitterAug(0.3),
        "ColorJitterAug": img.ColorJitterAug(0.2, 0.3, 0.4),
        "RandomGrayAug": img.RandomGrayAug(0.5),
        "HueJitterAug": img.HueJitterAug(0.3),
        "LightingAug": img.LightingAug(0.1, eig, vec),
        "SequentialAug": img.SequentialAug([img.RandomCropAug((8, 6)),
                                            img.CastAug()]),
        "RandomOrderAug": img.RandomOrderAug([img.BrightnessJitterAug(0.2),
                                              img.ContrastJitterAug(0.2)]),
        "RandomSizedCropAug": img.RandomSizedCropAug((6, 6), 0.3,
                                                     (0.75, 1.33)),
        "ColorNormalizeAug": img.ColorNormalizeAug(
            np.array([123.68, 116.28, 103.53]),
            np.array([58.395, 57.12, 57.375])),
    }


_AUG_NAMES = list(_augs(mxj))


@pytest.mark.parametrize("name", _AUG_NAMES)
def test_augmenter_matches_jax(name):
    """Five draws of each augmenter under one seed, on a uint8 image and
    (colour ones) its float32 cast: uint8 bitwise, float within 1e-4."""
    src = _images(1, (12, 14))[0][0]
    outs = {}
    for label, mx in (("jax", mxj), ("port", mxt)):
        aug = _augs(mx)[name]
        _seed(5)
        outs[label] = [_np(aug(x)[0]) for _ in range(5)
                       for x in (src, src.astype(np.float32))]
    for g, w in zip(outs["port"], outs["jax"]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert _augs(mxt)[name].dumps() == _augs(mxj)[name].dumps()


@pytest.mark.parametrize("kw", [
    dict(rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(resize=16, rand_crop=True, rand_resize=True, brightness=0.2,
         contrast=0.2, saturation=0.2, hue=0.1, pca_noise=0.1, rand_gray=0.3),
], ids=["crop-mirror-normalize", "every-option"])
def test_create_augmenter_matches_jax(kw):
    src = _images(1, (20, 18))[0][0]
    outs = {}
    for label, mx in (("jax", mxj), ("port", mxt)):
        augs = mx.image.CreateAugmenter((3, 10, 12), **kw)
        _seed(9)
        res = []
        for _ in range(4):
            x = src
            for a in augs:
                x = a(x)[0]
            res.append(_np(x))
        outs[label] = ([type(a).__name__ for a in augs], res)
    assert outs["port"][0] == outs["jax"][0]
    for g, w in zip(outs["port"][1], outs["jax"][1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_image_functions_match_jax():
    src = _images(1, (21, 17))[0][0]
    for fn, args in (("resize_short", (9,)), ("imresize", (7, 11)),
                     ("fixed_crop", (2, 3, 8, 9, (5, 5))),
                     ("color_normalize", (np.array([1.0, 2.0, 3.0]),
                                          np.array([2.0, 3.0, 4.0])))):
        np.testing.assert_allclose(
            _np(getattr(mxt.image, fn)(src, *args)),
            _np(getattr(mxj.image, fn)(src, *args)), rtol=0, atol=1e-4)
    for fn in ("random_crop", "center_crop"):
        _seed(2)
        want = getattr(mxj.image, fn)(src, (8, 6))
        _seed(2)
        got = getattr(mxt.image, fn)(src, (8, 6))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    _seed(4)
    want = mxj.image.random_size_crop(src, (6, 6), 0.2, (0.75, 1.33))
    _seed(4)
    got = mxt.image.random_size_crop(src, (6, 6), 0.2, (0.75, 1.33))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert mxt.image.scale_down((5, 7), (8, 6)) == \
        mxj.image.scale_down((5, 7), (8, 6))
    t = mxt.image.imresize(torch.from_numpy(src), 7, 11)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8


@pytest.mark.parametrize("src_hw,dst_hw", [((256, 256), (224, 224)),
                                           ((300, 300), (224, 224)),
                                           ((20, 20), (16, 16))])
def test_resize_without_cv2_matches_jax_image_resize(src_hw, dst_hw,
                                                     no_decoders):
    """Without cv2 both packages resize bilinearly with antialiasing: torch's
    ``interpolate`` against ``jax.image.resize``, within 5e-3 before the
    truncation to uint8 and one intensity level after it."""
    import jax
    no_decoders()
    src = np.random.RandomState(0).randint(0, 256, src_hw + (3,)).astype(
        np.uint8)
    want_f = np.asarray(jax.image.resize(src.astype(np.float32),
                                         dst_hw + (3,), method="bilinear"))
    got = mxt.image.imresize(src, dst_hw[1], dst_hw[0])
    got_f = mxt.image._resize_np(src.astype(np.float32), dst_hw[1],
                                 dst_hw[0])
    assert got.dtype == np.uint8 and got.shape == dst_hw + (3,)
    assert np.abs(got_f - want_f).max() <= 5e-3
    diff = np.abs(got.astype(int) - want_f.astype(np.uint8).astype(int))
    assert diff.max() <= 1


# -- ImageRecordIter -----------------------------------------------------------
def _epochs(it, n=2):
    """Every batch of ``n`` epochs, each consumed to its end (so that the
    prefetch thread has stopped drawing): (data, label, pad, dtype)."""
    out = []
    for e in range(n):
        if e:
            it.reset()
        for b in it:
            out.append((_np(b.data[0]), _np(b.label[0]), b.pad,
                        str(b.data[0].dtype)))
    return out


def _same_batches(got, want, atol):
    assert len(got) == len(want) > 0
    for (gd, gl, gp, _), (wd, wl, wp, _) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gl, wl)
        assert gd.shape == wd.shape
        np.testing.assert_allclose(gd, wd, rtol=0, atol=atol)


_ITER_KW = dict(data_shape=(3, 8, 10), batch_size=4, shuffle=True,
                rand_crop=True, rand_mirror=True, preprocess_threads=1,
                prefetch_buffer=2, **MEAN)


@pytest.mark.parametrize("mode", ["host", "device-float32",
                                  "device-bfloat16"])
def test_image_record_iter_matches_jax(tmp_path, no_decoders, mode):
    """Two shuffled epochs of cropped, mirrored, normalised batches equal
    the JAX package's under the same seeds; ``device_augment`` runs the
    float work as torch ops (on the CPU here), the bf16 output within one
    bf16 rounding of the JAX package's."""
    imgs, labels = _images(10, (12, 14))
    rec = _write_images(mxt, tmp_path / "img", imgs, labels)
    kw = dict(_ITER_KW)
    if mode != "host":
        kw.update(device_augment=True, device_dtype=mode.split("-")[1])
    _seed(1)
    got_it = mxt.io.ImageRecordIter(rec, ctx=CPU, **kw)
    got = _epochs(got_it)
    no_decoders()
    _seed(1)
    want = _epochs(mxj.io.ImageRecordIter(rec, **kw))
    assert got[0][3] == ("torch.float32" if mode != "device-bfloat16"
                         else "torch.bfloat16")
    assert got_it.provide_data[0].shape == (4, 3, 8, 10)
    _same_batches(got, want, 1e-4 if mode != "device-bfloat16" else 0.04)


def test_device_augment_matches_host_path(tmp_path):
    """Without the mirror (whose flips the two paths draw from different
    streams) the device path gives the host path's float32 batches under
    the same seed, within 1e-4."""
    imgs, labels = _images(8, (12, 14), seed=2)
    rec = _write_images(mxt, tmp_path / "img", imgs, labels)
    kw = dict(_ITER_KW, rand_mirror=False)
    res = []
    for dev in (False, True):
        _seed(3)
        res.append(_epochs(mxt.io.ImageRecordIter(
            rec, ctx=CPU, device_augment=dev, device_dtype="float32", **kw)))
    _same_batches(res[1], res[0], 1e-4)


def test_image_record_iter_png_matches_jax(tmp_path):
    pytest.importorskip("PIL")
    imgs, labels = _images(6, (10, 12), seed=4)
    rec = _write_images(mxt, tmp_path / "png", imgs, labels, fmt=".png")
    kw = dict(_ITER_KW, batch_size=3, data_shape=(3, 8, 8))
    _seed(6)
    got = _epochs(mxt.io.ImageRecordIter(rec, ctx=CPU, **kw), 1)
    _seed(6)
    want = _epochs(mxj.io.ImageRecordIter(rec, **kw), 1)
    _same_batches(got, want, 1e-4)


# -- TensorRecordIter ------------------------------------------------------------
@pytest.mark.parametrize("case", [
    dict(n=10, batch_size=4),
    dict(n=10, batch_size=4, shuffle=True, seed=3),
    dict(n=12, batch_size=4, label_width=3),
    dict(n=10, batch_size=4, round_batch=False),
], ids=["pad", "shuffle", "label_width", "no_round_batch"])
def test_tensor_record_iter_matches_jax(tmp_path, case):
    """Records the port writes, read by the port's native loader and the
    JAX package's: every batch's uint8 data, labels and pad bitwise, over
    two epochs (a shuffle reorders each epoch)."""
    case = dict(case)
    n, lw = case.pop("n"), case.get("label_width", 1)
    rs = np.random.RandomState(8)
    data = rs.randint(0, 256, (n, 3, 4, 5)).astype(np.uint8)
    labels = rs.randint(0, 100, (n, lw)).astype(np.float32)
    path = str(tmp_path / "t.rec")
    mxt.io.save_tensor_rec(path, data, labels[:, 0] if lw == 1 else labels)
    jax_native = mxnet_tpu._native.lib() is not None
    got = _epochs(mxt.io.TensorRecordIter(path, (3, 4, 5), ctx=CPU, **case))
    want = _epochs(mxj.io.TensorRecordIter(path, (3, 4, 5), **case))
    if case.get("shuffle") and not jax_native:
        # the JAX package's numpy fallback shuffles another way
        for g in (got[:3], got[3:]):
            assert sorted(np.concatenate([b[1] for b in g]).tolist()) == \
                sorted(labels[:, 0].tolist())
        return
    _same_batches(got, want, 0)
    assert got[0][0].dtype == np.uint8


def test_tensor_record_iter_pads_label_rows(tmp_path):
    """A padded last batch with ``label_width`` > 1 repeats whole rows
    (the JAX package pads the flat label vector and fails here)."""
    data = np.arange(5 * 6, dtype=np.uint8).reshape(5, 6)
    labels = np.arange(10, dtype=np.float32).reshape(5, 2)
    path = str(tmp_path / "t.rec")
    mxt.io.save_tensor_rec(path, data, labels)
    it = mxt.io.TensorRecordIter(path, (6,), 4, label_width=2, ctx=CPU)
    last = list(it)[-1]
    assert last.pad == 3
    np.testing.assert_array_equal(_np(last.data[0]), data[[4, 4, 4, 4]])
    np.testing.assert_array_equal(_np(last.label[0]), labels[[4, 4, 4, 4]])
    with pytest.raises(mxt.MXNetError):
        mxt.io.TensorRecordIter(str(tmp_path / "missing.rec"), (6,), 4,
                                ctx=CPU)


def test_native_runtime_builds_from_the_repository():
    from mxnet_tpu_torch import _native
    path = _native.lib_path()
    assert os.path.dirname(path).endswith(os.path.join("build", "runtime"))
    assert "mxnet_tpu" + os.sep not in path
    assert _native.lib().MXTBatchLoaderNumSamples is not None


# -- detection -----------------------------------------------------------------
def _det_label(rs, nobj):
    boxes = []
    for _ in range(nobj):
        x1, y1 = rs.uniform(0, 0.5, 2)
        boxes += [float(rs.randint(0, 3)), x1, y1, x1 + rs.uniform(0.2, 0.5),
                  y1 + rs.uniform(0.2, 0.5)]
    return np.array([2, 5] + boxes, np.float32)


def _det_augs(mx):
    det, img = mx.detection, mx.image
    return {
        "flip": det.DetHorizontalFlipAug(1.0),
        "crop": det.DetRandomCropAug(min_object_covered=0.3),
        "pad": det.DetRandomPadAug(area_range=(1.0, 2.5)),
        "select": det.DetRandomSelectAug(
            [det.DetRandomCropAug(), det.DetRandomPadAug()], 0.2),
        "multi_crop": det.CreateMultiRandCropAugmenter(
            min_object_covered=[0.1, 0.5], area_range=(0.2, 1.0)),
        "borrow": det.DetBorrowAug(img.ColorNormalizeAug(
            np.array([1.0, 2.0, 3.0]), np.array([2.0, 2.0, 2.0]))),
    }


@pytest.mark.parametrize("name", list(_det_augs(mxj)))
def test_det_augmenter_matches_jax(name):
    """Each detection augmenter, six draws under one numpy seed: the boxes
    within 1e-6 and the images equal (floats within 1e-4)."""
    rs = np.random.RandomState(5)
    src = rs.randint(0, 256, (20, 24, 3)).astype(np.uint8)
    label = mxj.detection.ImageDetIter._parse_label(_det_label(rs, 3))
    outs = {}
    for k, mx in (("jax", mxj), ("port", mxt)):
        aug = _det_augs(mx)[name]
        _seed(7)
        outs[k] = [tuple(_np(v) for v in aug(src, label.copy()))
                   for _ in range(6)]
    for (gi, gl), (wi, wl) in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-4)


def test_create_det_augmenter_matches_jax():
    rs = np.random.RandomState(6)
    src = rs.randint(0, 256, (20, 24, 3)).astype(np.uint8)
    label = mxj.detection.ImageDetIter._parse_label(_det_label(rs, 2))
    outs = {}
    for k, mx in (("jax", mxj), ("port", mxt)):
        augs = mx.detection.CreateDetAugmenter(
            (3, 12, 12), rand_crop=0.7, rand_pad=0.5, rand_mirror=True,
            mean=True, std=True)
        _seed(2)
        res = []
        for _ in range(5):
            x, lab = src, label.copy()
            for a in augs:
                x, lab = a(x, lab)
            res.append((_np(x), lab))
        outs[k] = res
    for (gi, gl), (wi, wl) in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-4)


def test_image_det_record_iter_matches_jax(tmp_path, no_decoders):
    """Labels padded with -1 to the largest object count, data normalised;
    the last batch padded: equal to the JAX package's."""
    rs = np.random.RandomState(9)
    rec = mxt.recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                         str(tmp_path / "d.rec"), "w")
    for i in range(7):
        img = rs.randint(0, 256, (12, 12, 3)).astype(np.uint8)
        rec.write_idx(i, mxt.recordio.pack_img(
            (0, _det_label(rs, i % 3 + 1), i, 0), img, img_fmt=".npy"))
    rec.close()
    kw = dict(data_shape=(3, 12, 12), batch_size=3, mean_r=1.0, std_g=2.0,
              prefetch_buffer=2)
    got_it = mxt.io.ImageDetRecordIter(str(tmp_path / "d.rec"), ctx=CPU,
                                       **kw)
    got = _epochs(got_it, 1)
    no_decoders()
    want = _epochs(mxj.io.ImageDetRecordIter(str(tmp_path / "d.rec"), **kw),
                   1)
    assert got_it.provide_label[0].shape == (3, 3, 5)
    _same_batches(got, want, 1e-4)
    assert got[-1][2] == 2 and (got[-1][1][1:] == -1).all()


# -- datasets --------------------------------------------------------------------
def test_record_datasets_match_jax(tmp_path, no_decoders):
    imgs, labels = _images(5, (6, 7), seed=11)
    rec = _write_images(mxt, tmp_path / "ds", imgs, labels)
    raw = mxt.gluon.data.RecordFileDataset(rec)
    assert len(raw) == 5
    folder = tmp_path / "folder"
    for c, cls in enumerate(("cat", "dog")):
        os.makedirs(folder / cls)
        for i in range(2):
            png = mxt.recordio._imencode(imgs[2 * c + i], img_fmt=".png")
            (folder / cls / f"{i}.png").write_bytes(png)
    (folder / "notes.txt").write_text("not a class")
    with mxt.cpu():
        got_rec = [(_np(x), float(y)) for x, y in
                   mxt.gluon.data.vision.ImageRecordDataset(rec)]
        got_dir = mxt.gluon.data.vision.ImageFolderDataset(str(folder))
        got_dir_items = [(_np(x), y) for x, y in got_dir]
        loader = mxt.gluon.data.DataLoader(
            mxt.gluon.data.vision.ImageRecordDataset(rec), batch_size=5)
        xb, yb = next(iter(loader))
    assert got_dir.synsets == ["cat", "dog"]
    want_dir = mxj.gluon.data.vision.ImageFolderDataset(str(folder))
    for (g, gy), (w, wy) in zip(got_dir_items, want_dir):
        np.testing.assert_array_equal(g, _np(w))
        assert gy == wy
    no_decoders()
    want_raw = mxj.gluon.data.RecordFileDataset(rec)
    assert [raw[i] for i in range(5)] == [want_raw[i] for i in range(5)]
    want = [(_np(x), float(y)) for x, y in
            mxj.gluon.data.vision.ImageRecordDataset(rec)]
    for (g, gy), (w, wy) in zip(got_rec, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.uint8 and gy == wy
    assert tuple(xb.shape) == (5, 6, 7, 3)
    np.testing.assert_array_equal(_np(yb), labels)


def test_record_dataset_reads_are_safe_across_loader_workers(tmp_path):
    """Worker threads share one record file: each item must still be its own
    record, batch for batch as with no workers."""
    imgs, labels = _images(96, (64, 64), seed=12)
    rec = _write_images(mxt, tmp_path / "mt", imgs, labels)
    batches = {}
    with mxt.cpu():
        for workers in (0, 4):
            loader = mxt.gluon.data.DataLoader(
                mxt.gluon.data.vision.ImageRecordDataset(rec), batch_size=3,
                num_workers=workers)
            batches[workers] = [(_np(x), _np(y)) for x, y in loader]
    assert len(batches[4]) == len(batches[0]) == 32
    for (x0, y0), (x4, y4) in zip(batches[0], batches[4]):
        np.testing.assert_array_equal(x4, x0)
        np.testing.assert_array_equal(y4, y0)
    np.testing.assert_array_equal(
        np.concatenate([x for x, _ in batches[4]]), imgs)
