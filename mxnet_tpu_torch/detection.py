"""Detection data: box-aware augmenters and ``ImageDetIter`` (parity:
python/mxnet/image/detection.py, src/io/iter_image_det_recordio.cc,
src/io/image_det_aug_default.cc).

The counterpart of ``mxnet_tpu/detection.py``.  A raw label is ``[header
width, object width, ...header..., (id, xmin, ymin, xmax, ymax, ...) per
object]`` with corners normalised to [0, 1]; batches pad the objects to the
dataset's largest count with rows of ``label_pad_value`` (-1), what
``MultiBoxTarget`` reads.  The augmenters run on numpy images on the host
and draw from numpy's global RNG in the JAX package's order; a borrowed
image augmenter (``DetBorrowAug``) gets the numpy image directly.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import io as _io
from . import image as _img
from .base import MXNetError
from .ndarray import array


def _host(src):
    return src.detach().cpu().numpy() if isinstance(src, torch.Tensor) \
        else src


class DetAugmenter:
    """Base: ``aug(src, label) -> (src, label)``, label rows (id, x1, y1,
    x2, y2, ...)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    dumps = _img.Augmenter.dumps

    def __call__(self, src, label):
        return src, label


class DetBorrowAug(DetAugmenter):
    """An image augmenter that moves no geometry (color, cast, normalize,
    the final resize)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src)[0], label


class DetRandomSelectAug(DetAugmenter):
    """One of ``aug_list`` at random, or none with ``skip_prob``."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _np.random.random() < self.skip_prob or not self.aug_list:
            return src, label
        return self.aug_list[_np.random.randint(len(self.aug_list))](src,
                                                                      label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and its boxes left-right with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _np.random.random() < self.p:
            src = _host(src)[:, ::-1, :].copy()
            label = label.copy()
            tmp = 1.0 - label[:, 1]
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = tmp
        return src, label


def _box_areas(boxes):
    return _np.maximum(0, boxes[:, 2] - boxes[:, 0]) * \
        _np.maximum(0, boxes[:, 3] - boxes[:, 1])


def _crop_update_label(label, x1, y1, x2, y2, min_eject_coverage):
    """The boxes in the crop's coordinates, without the objects that the
    crop keeps less than ``min_eject_coverage`` of; None if none is left."""
    w, h = x2 - x1, y2 - y1
    boxes = label[:, 1:5]
    inter_x1 = _np.maximum(boxes[:, 0], x1)
    inter_y1 = _np.maximum(boxes[:, 1], y1)
    inter_x2 = _np.minimum(boxes[:, 2], x2)
    inter_y2 = _np.minimum(boxes[:, 3], y2)
    iw = _np.maximum(0, inter_x2 - inter_x1)
    ih = _np.maximum(0, inter_y2 - inter_y1)
    coverage = iw * ih / _np.maximum(_box_areas(boxes), 1e-12)
    keep = coverage > min_eject_coverage
    if not keep.any():
        return None
    out = label[keep].copy()
    out[:, 1] = _np.clip((inter_x1[keep] - x1) / w, 0, 1)
    out[:, 2] = _np.clip((inter_y1[keep] - y1) / h, 0, 1)
    out[:, 3] = _np.clip((inter_x2[keep] - x1) / w, 0, 1)
    out[:, 4] = _np.clip((inter_y2[keep] - y1) / h, 0, 1)
    return out


class DetRandomCropAug(DetAugmenter):
    """A random crop of random area and aspect ratio that covers at least
    ``min_object_covered`` of some object, tried ``max_attempts`` times."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        arr = _host(src)
        H, W = arr.shape[:2]
        for _ in range(self.max_attempts):
            area = _np.random.uniform(*self.area_range)
            ratio = _np.random.uniform(*self.aspect_ratio_range)
            cw = min(1.0, _np.sqrt(area * ratio))
            ch = min(1.0, _np.sqrt(area / ratio))
            x1 = _np.random.uniform(0, 1 - cw)
            y1 = _np.random.uniform(0, 1 - ch)
            x2, y2 = x1 + cw, y1 + ch
            boxes = label[:, 1:5]
            inter = _np.stack([_np.maximum(boxes[:, 0], x1),
                               _np.maximum(boxes[:, 1], y1),
                               _np.minimum(boxes[:, 2], x2),
                               _np.minimum(boxes[:, 3], y2)], axis=1)
            cover = _box_areas(inter) / _np.maximum(_box_areas(boxes), 1e-12)
            if cover.max(initial=0.0) < self.min_object_covered:
                continue
            new_label = _crop_update_label(label, x1, y1, x2, y2,
                                           self.min_eject_coverage)
            if new_label is None:
                continue
            px1, py1 = int(x1 * W), int(y1 * H)
            px2, py2 = max(px1 + 1, int(x2 * W)), max(py1 + 1, int(y2 * H))
            return arr[py1:py2, px1:px2, :], new_label
        return arr, label


class DetRandomPadAug(DetAugmenter):
    """Place the image on a larger canvas of ``pad_val``, shrinking the
    boxes to match."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        arr = _host(src)
        H, W = arr.shape[:2]
        area = _np.random.uniform(*self.area_range)
        if area <= 1.0:
            return arr, label
        ratio = _np.random.uniform(*self.aspect_ratio_range)
        nw = max(int(W * min(4.0, _np.sqrt(area * ratio))), W)
        nh = max(int(H * min(4.0, _np.sqrt(area / ratio))), H)
        ox = _np.random.randint(0, nw - W + 1)
        oy = _np.random.randint(0, nh - H + 1)
        canvas = _np.empty((nh, nw, arr.shape[2]), arr.dtype)
        canvas[...] = _np.asarray(self.pad_val, arr.dtype)[:arr.shape[2]]
        canvas[oy:oy + H, ox:ox + W, :] = arr
        out = label.copy()
        out[:, 1] = (out[:, 1] * W + ox) / nw
        out[:, 2] = (out[:, 2] * H + oy) / nh
        out[:, 3] = (out[:, 3] * W + ox) / nw
        out[:, 4] = (out[:, 4] * H + oy) / nh
        return canvas, out


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """One ``DetRandomCropAug`` per parameter combination behind a random
    selector; scalars broadcast to the longest list."""
    def listify(v):
        return v if isinstance(v, list) else [v]

    lists = {"min_object_covered": listify(min_object_covered),
             "aspect_ratio_range": listify(aspect_ratio_range),
             "area_range": listify(area_range),
             "min_eject_coverage": listify(min_eject_coverage),
             "max_attempts": listify(max_attempts)}
    n = max(len(v) for v in lists.values())
    for name, lst in lists.items():
        if len(lst) not in (1, n):
            raise ValueError(f"{name}: length {len(lst)} != {n}")
    crops = [DetRandomCropAug(**{k: v[i % len(v)] for k, v in lists.items()})
             for i in range(n)]
    return DetRandomSelectAug(crops, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """The detection augmenter list, in the reference's order: resize,
    pad, crop, mirror, the resize to the input, color, gray, normalize."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_pad > 0:
        auglist.append(DetRandomSelectAug(
            [DetRandomPadAug(aspect_ratio_range,
                             (1.0, max(1.0, area_range[1])), max_attempts,
                             pad_val)],
            1 - rand_pad))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (min(area_range[0], 1.0), 1.0),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_mirror:
        # True is the reference's coin; a float is the probability
        auglist.append(DetHorizontalFlipAug(
            0.5 if rand_mirror is True else float(rand_mirror)))
    auglist.append(DetBorrowAug(
        _img.ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            _img.ColorJitterAug(brightness, contrast, saturation)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(_img.RandomGrayAug(rand_gray)))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(_img.ImageIter):
    """Detection iterator over a ``.rec``, a list file or a list: parses
    the labels, applies the detection augmenters, and yields (B, C, H, W)
    float32 data and (B, max objects, object width) labels padded with
    ``label_pad_value``, on its context."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 label_pad_width=0, label_pad_value=-1.0, ctx=None,
                 **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name, ctx=ctx)
        self.auglist = CreateDetAugmenter(data_shape, **kwargs) \
            if aug_list is None else aug_list
        self.label_pad_value = float(label_pad_value)
        label_shape = self._estimate_label_shape()
        if label_pad_width > 0:
            if label_pad_width < label_shape[0]:
                raise MXNetError(
                    f"label_pad_width {label_pad_width} < dataset max "
                    f"object count {label_shape[0]}")
            label_shape = (label_pad_width, label_shape[1])
        self.label_shape = label_shape
        self.provide_label = [_io.DataDesc(label_name,
                                           (batch_size,) + label_shape)]

    @staticmethod
    def _parse_label(label):
        """A raw label vector as an (objects, object width) array, the
        invalid boxes dropped."""
        raw = _np.asarray(_host(label), _np.float32).ravel()
        if raw.size < 7:
            raise MXNetError(f"Label shape is invalid: {raw.shape}")
        header_width, obj_width = int(raw[0]), int(raw[1])
        if (raw.size - header_width) % obj_width != 0:
            raise MXNetError(
                f"Label shape {raw.shape} inconsistent with annotation "
                f"width {obj_width}")
        out = raw[header_width:].reshape((-1, obj_width))
        valid = _np.where((out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2]))[0]
        if valid.size < 1:
            raise MXNetError("Encounter sample with no valid label.")
        return out[valid, :]

    def _estimate_label_shape(self):
        max_count, width = 0, 5
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                parsed = self._parse_label(label)
                max_count = max(max_count, parsed.shape[0])
                width = parsed.shape[1]
        except StopIteration:
            pass
        self.reset()
        return (max_count, width)

    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.provide_data = [_io.DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + tuple(data_shape))]
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self.label_shape = tuple(label_shape)
            self.provide_label = [_io.DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + tuple(label_shape))]

    def _decode_augment_det(self, sample):
        raw_label, s = sample
        arr = _img.imdecode_np(s)
        label = self._parse_label(raw_label)
        for aug in self.auglist:
            arr, label = aug(arr, label)
            arr = _host(arr)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr, label

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = _np.zeros((batch_size, h, w, c), _np.float32)
        batch_label = _np.full((batch_size,) + self.label_shape,
                               self.label_pad_value, _np.float32)
        samples = []
        while len(samples) < batch_size:
            try:
                samples.append(self.next_sample())
            except StopIteration:
                if not samples:
                    raise
                break
        results = self._map_pool(self._decode_augment_det, samples)
        for i, (arr, label) in enumerate(results):
            batch_data[i] = arr[:h, :w, :c]
            n = min(label.shape[0], self.label_shape[0])
            batch_label[i, :n, :label.shape[1]] = label[:n]
        data = _np.ascontiguousarray(batch_data.transpose(0, 3, 1, 2))
        return _io.DataBatch([array(data, ctx=self._device)],
                             [array(batch_label, ctx=self._device)],
                             batch_size - len(results),
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)


def ImageDetRecordIter(path_imgrec, data_shape, batch_size, shuffle=False,
                       mean_r=0., mean_g=0., mean_b=0., std_r=1., std_g=1.,
                       std_b=1., rand_crop_prob=0., rand_pad_prob=0.,
                       rand_mirror_prob=0., label_pad_width=0,
                       label_pad_value=-1.0, preprocess_threads=4,
                       prefetch_buffer=4, ctx=None, **kwargs):
    """The detection iterator over a ``.rec`` behind a prefetch thread
    (parity: iter_image_det_recordio.cc's ImageDetRecordIter)."""
    mean = _np.array([mean_r, mean_g, mean_b]) \
        if any((mean_r, mean_g, mean_b)) else None
    std = _np.array([std_r, std_g, std_b]) \
        if any(s != 1 for s in (std_r, std_g, std_b)) else None
    it = ImageDetIter(batch_size=batch_size, data_shape=tuple(data_shape),
                      path_imgrec=path_imgrec, shuffle=shuffle,
                      rand_crop=rand_crop_prob, rand_pad=rand_pad_prob,
                      rand_mirror=rand_mirror_prob, mean=mean, std=std,
                      label_pad_width=label_pad_width,
                      label_pad_value=label_pad_value, ctx=ctx, **kwargs)
    return _io.PrefetchingIter(it, depth=int(prefetch_buffer))
