"""Image decoding, augmentation and the image iterators (parity:
python/mxnet/image/image.py, src/io/image_aug_default.cc,
src/io/iter_image_recordio_2.cc).

The counterpart of ``mxnet_tpu/image.py``.  The augmenters are numpy on
the host, as in the JAX package: a numpy image in gives a numpy image out,
a tensor in gives a tensor on its device.  They draw from the same streams
in the same order (crops, jitters and the host mirror from Python's
``random``, the PCA noise from numpy's global RNG), so one seed gives the
JAX package's images.

Resizing uses cv2 where it is installed (bilinear, as the JAX package with
cv2); without it, ``torch.nn.functional.interpolate(mode="bilinear",
antialias=True)`` on the CPU, truncated to the input's dtype.  That is the
JAX package's ``jax.image.resize(..., "bilinear")`` fallback within 5e-3
before truncation (one intensity level after it, at a few pixels).

``ImageIter`` reads a ``.rec`` (with or without an ``.idx``), an image list
file or a list of (label, path) and decodes and augments each batch on a
thread pool (``preprocess_threads``).  Batches land on the iterator's
context (``ctx``, else the current context when it is built: ``gpu(0)``
unless the caller entered another).  With ``device_augment`` the host
decodes and crops only and uploads one uint8 NHWC batch; the mirror
select, the cast, the mean/std and the NCHW transpose run on the device in
torch ops, in ``device_dtype``, on a stream of their own that the batch
waits for before it is handed on.
"""
from __future__ import annotations

import json
import os
import random as _pyrandom
from typing import List

import numpy as _np
import torch

from . import io as _io
from . import recordio
from .base import MXNetError, torch_dtype
from .context import as_device
from .ndarray import array


def _as_np(src) -> _np.ndarray:
    if isinstance(src, torch.Tensor):
        return src.detach().cpu().numpy()
    return _np.asarray(src)


def _like(arr: _np.ndarray, src):
    """``arr`` as ``src``'s type: a numpy array, or a tensor on ``src``'s
    device."""
    if isinstance(src, torch.Tensor):
        return torch.from_numpy(_np.ascontiguousarray(arr)).to(src.device)
    return arr


def imdecode_np(buf, flag=1, to_rgb=True) -> _np.ndarray:
    """Decode image bytes to an HWC numpy array (the iterators' path)."""
    img = recordio._imdecode_bytes(buf, flag)
    if img is None:
        raise MXNetError("image decode failed")
    if to_rgb and img.ndim == 3:
        img = _np.ascontiguousarray(img[:, :, ::-1])
    return img


def imdecode(buf, flag=1, to_rgb=True, out=None, ctx=None) -> torch.Tensor:
    """Decode image bytes to an HWC tensor on ``ctx`` (parity:
    mx.image.imdecode)."""
    return array(imdecode_np(buf, flag, to_rgb), ctx=ctx)


def imread(filename, flag=1, to_rgb=True, ctx=None) -> torch.Tensor:
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb, ctx=ctx)


def _resize_np(src: _np.ndarray, w, h) -> _np.ndarray:
    try:
        import cv2
        return cv2.resize(src, (w, h), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        pass
    x = torch.from_numpy(_np.ascontiguousarray(src, dtype=_np.float32))
    chw = x.reshape(x.shape[0], x.shape[1], -1).permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(chw, size=(h, w), mode="bilinear",
                                          antialias=True, align_corners=False)
    out = out[0].permute(1, 2, 0).reshape((h, w) + src.shape[2:])
    return out.numpy().astype(src.dtype)


def imresize(src, w, h, interp=1):
    return _like(_resize_np(_as_np(src), w, h), src)


def resize_short(src, size, interp=2):
    """Resize the shorter edge to ``size``, keeping the aspect ratio."""
    arr = _as_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _like(_resize_np(arr, new_w, new_h), src)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    arr = _as_np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize_np(out, size[0], size[1])
    return _like(out, src)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = _pyrandom.randint(0, max(0, w - new_w))
    y0 = _pyrandom.randint(0, max(0, h - new_h))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size)
    return out, (x0, y0, new_w, new_h)


def scale_down(src_size, size):
    """Shrink a crop ``size`` (w, h) to fit in ``src_size`` (w, h), keeping
    its aspect ratio."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """A random crop of random area and aspect ratio resized to ``size``
    (the inception crop); a random fitting crop when ten tries fail."""
    h, w = src.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = _pyrandom.uniform(min_area, 1.0) * area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round((target_area * new_ratio) ** 0.5))
        new_h = int(round((target_area / new_ratio) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return random_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    arr = _as_np(src).astype(_np.float32, copy=False)
    if mean is not None:
        arr = arr - _as_np(mean).astype(_np.float32)
    if std is not None:
        arr = arr * (1.0 / _as_np(std).astype(_np.float32))
    return _like(arr, src)


_GRAY = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)


class Augmenter:
    """Base augmenter: ``aug(img)`` returns a list of images."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs],
                          default=lambda o: o.tolist()
                          if hasattr(o, "tolist") else str(o))

    def __call__(self, src):
        raise NotImplementedError


class _SizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size


class ResizeAug(_SizeAug):
    def __call__(self, src):
        return [resize_short(src, self.size)]


class ForceResizeAug(_SizeAug):
    def __call__(self, src):
        return [imresize(src, self.size[0], self.size[1])]


class RandomCropAug(_SizeAug):
    def __call__(self, src):
        return [random_crop(src, self.size)[0]]


class CenterCropAug(_SizeAug):
    def __call__(self, src):
        return [center_crop(src, self.size)[0]]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return [_like(_np.ascontiguousarray(_as_np(src)[:, ::-1]), src)]
        return [src]


class CastAug(Augmenter):
    def __call__(self, src):
        if isinstance(src, torch.Tensor):
            return [src.float()]
        return [src.astype(_np.float32)]


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return [src * alpha]


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        arr = _as_np(src).astype(_np.float32, copy=False)
        gray = float((arr * _GRAY).sum() * (3.0 / arr.size))
        return [_like(arr * alpha + gray * (1.0 - alpha), src)]


class SaturationJitterAug(Augmenter):
    """Blend with the per-pixel gray."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        arr = _as_np(src).astype(_np.float32, copy=False)
        gray = (arr * _GRAY).sum(axis=2, keepdims=True)
        return [_like(arr * alpha + gray * (1.0 - alpha), src)]


class ColorJitterAug(Augmenter):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness, contrast, saturation):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.ts = []
        if brightness > 0:
            self.ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            self.ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            self.ts.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        order = list(range(len(self.ts)))
        _pyrandom.shuffle(order)
        for i in order:
            src = self.ts[i](src)[0]
        return [src]


class RandomGrayAug(Augmenter):
    """Three-channel gray with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = _as_np(src).astype(_np.float32, copy=False)
            gray = (arr * _GRAY).sum(axis=2, keepdims=True)
            src = _like(_np.repeat(gray, 3, axis=2), src)
        return [src]


class HueJitterAug(Augmenter):
    """Rotate the chroma in YIQ space by a random angle in [-hue, hue]·π."""

    _TYIQ = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], _np.float32)
    _ITYIQ = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        rot = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                        _np.float32)
        t = (self._ITYIQ @ rot @ self._TYIQ).T
        arr = _as_np(src).astype(_np.float32, copy=False)
        return [_like(arr @ t, src)]


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise: add eigvec·(alpha∘eigval), alpha drawn
    from N(0, alphastd) by numpy's global RNG."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = self.eigvec @ (alpha * self.eigval)
        arr = _as_np(src).astype(_np.float32, copy=False)
        return [_like(arr + rgb.astype(_np.float32), src)]


class SequentialAug(Augmenter):
    """The sub-augmenters in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        imgs = [src]
        for aug in self.ts:
            imgs = [out for img in imgs for out in aug(img)]
        return imgs

    def dumps(self):
        return [self.__class__.__name__.lower(), [a.dumps() for a in self.ts]]


class RandomOrderAug(SequentialAug):
    """The sub-augmenters in a random order."""

    def __call__(self, src):
        order = list(self.ts)
        _pyrandom.shuffle(order)
        imgs = [src]
        for aug in order:
            imgs = [out for img in imgs for out in aug(img)]
        return imgs


class RandomSizedCropAug(Augmenter):
    """``random_size_crop`` as an augmenter (the inception crop)."""

    def __init__(self, size, min_area, ratio, interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)
        self.size = size
        self.min_area = min_area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return [random_size_crop(src, self.size, self.min_area, self.ratio,
                                 self.interp)[0]]


class ColorNormalizeAug(Augmenter):
    """(x - mean) * (1 / std) in float32."""

    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = None if mean is None \
            else _np.asarray(_as_np(mean), _np.float32)
        self._inv_std = None if std is None \
            else (1.0 / _np.asarray(_as_np(std), _np.float32))

    def __call__(self, src):
        arr = _as_np(src).astype(_np.float32, copy=False)
        if self.mean is not None:
            arr = arr - self.mean
        if self._inv_std is not None:
            arr = arr * self._inv_std
        return [_like(arr, src)]


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """The standard augmenter list (parity: image.CreateAugmenter):
    resize, crop (inception crop with ``rand_resize``), mirror, cast, the
    color jitters in a random order, hue, PCA lighting, gray, normalize."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08,
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    jitters: List[Augmenter] = []
    if brightness:
        jitters.append(BrightnessJitterAug(brightness))
    if contrast:
        jitters.append(ContrastJitterAug(contrast))
    if saturation:
        jitters.append(SaturationJitterAug(saturation))
    if len(jitters) > 1:
        auglist.append(RandomOrderAug(jitters))
    else:
        auglist.extend(jitters)
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


_GEOMETRIC = (ResizeAug, RandomCropAug, CenterCropAug, ForceResizeAug)


class ImageIter(_io.DataIter):
    """Image iterator over a ``.rec``, an image list file or a list of
    (label, path): decodes and augments on ``preprocess_threads`` threads
    and yields NCHW float32 batches on its context."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", preprocess_threads=4, ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        self._device = as_device(ctx)
        self._n_workers = max(1, int(preprocess_threads))
        self._pool = None
        self._device_augment = False
        self._device_dtype = "float32"
        self._dev_aug = None
        self._stream = None
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.imgidx = None
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(path_imgidx,
                                                         path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
        else:
            self.imgrec = None
        self.imglist = None
        self._rec_offsets = None
        self.path_root = path_root
        if path_imglist:
            imglist_d, imgkeys = {}, []
            with open(path_imglist) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    key = int(line[0])
                    imglist_d[key] = (_np.array(line[1:-1], _np.float32),
                                      line[-1])
                    imgkeys.append(key)
            self.imglist, self.seq = imglist_d, imgkeys
        elif isinstance(imglist, list):
            imglist_d, imgkeys = {}, []
            for i, img in enumerate(imglist):
                key = str(i)
                label = img[0] if isinstance(img[0], _np.ndarray) \
                    else _np.array(img[0], dtype=_np.float32)
                imglist_d[key] = (label, img[1])
                imgkeys.append(key)
            self.imglist, self.seq = imglist_d, imgkeys
        elif self.imgidx is not None:
            self.seq = self.imgidx
        elif shuffle and self.imgrec is not None:
            # no index file: one scan for the record offsets, so that a
            # shuffle needs none
            self._rec_offsets = []
            while True:
                pos = self.imgrec.tell()
                if self.imgrec.read() is None:
                    break
                self._rec_offsets.append(pos)
            self.imgrec.reset()
            self.seq = list(range(len(self._rec_offsets)))
        else:
            self.seq = None
        assert len(data_shape) == 3 and data_shape[0] == 3 \
            or data_shape[0] == 1
        self.provide_data = [_io.DataDesc(data_name,
                                          (batch_size,) + tuple(data_shape))]
        self.provide_label = [_io.DataDesc(
            label_name, (batch_size, label_width) if label_width > 1
            else (batch_size,))]
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.num_parts = num_parts
        self.part_index = part_index
        self.auglist = CreateAugmenter(data_shape, **kwargs) \
            if aug_list is None else aug_list
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            _np.random.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """(label, image bytes) of the next sample; a record's image is a
        memoryview over the record."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                if self._rec_offsets is not None:
                    self.imgrec.seek(self._rec_offsets[idx])
                    s = self.imgrec.read()
                else:
                    s = self.imgrec.read_idx(idx)
                return self._split(s)
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root or "", fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        return self._split(s)

    @staticmethod
    def _split(s):
        header, offset = recordio._header(s)
        return header.label, memoryview(s)[offset:]

    def _decode_augment(self, s):
        """Decode and every augmenter, then CHW float32 (on a worker)."""
        data = imdecode_np(s)
        for aug in self.auglist:
            data = aug(data)[0]
        arr = _as_np(data)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        c, h, w = self.data_shape
        return _np.ascontiguousarray(arr[:h, :w, :c].transpose(2, 0, 1),
                                     dtype=_np.float32)

    def _decode_geometric_u8(self, s):
        """``device_augment``'s host part: decode and the resizes and crops
        only: (HWC view, whether the device still turns BGR to RGB).  The
        channel reversal of ``imdecode`` commutes with them, so a
        3-channel image taken whole is reversed on the device (on the
        host, a strided copy, it cost more than the decode)."""
        data = recordio._imdecode_view(s, 1)
        if data is None:
            raise MXNetError("image decode failed")
        c, h, w = self.data_shape
        swap = data.ndim == 3 and data.shape[2] == 3 and c == 3
        if data.ndim == 3 and not swap:
            data = _np.ascontiguousarray(data[:, :, ::-1])
        for aug in self.auglist:
            if isinstance(aug, _GEOMETRIC):
                data = aug(data)[0]
        arr = _as_np(data)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr[:h, :w, :c], swap

    def _device_aug_params(self):
        """(mean, 1/std, mirror) of the augmenter list, the first two as
        float32 tensors on the device or None."""
        if self._dev_aug is None:
            mean = inv_std = None
            mirror = False
            for aug in self.auglist:
                if isinstance(aug, ColorNormalizeAug):
                    if aug.mean is not None:
                        mean = torch.from_numpy(aug.mean).to(self._device)
                    if aug._inv_std is not None:
                        inv_std = torch.from_numpy(aug._inv_std).to(
                            self._device)
                elif isinstance(aug, HorizontalFlipAug):
                    mirror = True
            self._dev_aug = (mean, inv_std, mirror)
        return self._dev_aug

    def _device_batch(self, batch_u8, swaps, flips):
        """The device part of ``device_augment``: upload the uint8 NHWC
        batch, BGR to RGB where ``swaps``, then mirror select, cast,
        mean/std and the NCHW transpose in torch ops, in the JAX package's
        order; on the card on a stream of its own, waited for before the
        batch is handed on."""
        mean, inv_std, mirror = self._device_aug_params()
        dtype = torch_dtype(self._device_dtype)

        def run():
            x = torch.from_numpy(batch_u8).to(self._device)
            if swaps.all():
                x = x.flip(3)
            elif swaps.any():
                s = torch.from_numpy(swaps).to(self._device)
                x = torch.where(s[:, None, None, None], x.flip(3), x)
            x = x.float()
            if mirror:
                f = torch.from_numpy(flips).to(self._device)
                x = torch.where(f[:, None, None, None], x.flip(2), x)
            if mean is not None:
                x = x - mean
            if inv_std is not None:
                x = x * inv_std
            return x.to(dtype).permute(0, 3, 1, 2).contiguous()

        if self._device.type != "cuda":
            return run()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        with torch.cuda.stream(self._stream):
            out = run()
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        # the consumer reads the batch on the device's default stream:
        # its memory is not reused until that stream's work on it is done
        out.record_stream(torch.cuda.default_stream(self._device))
        return out

    def _map_pool(self, fn, items):
        """``fn`` over ``items`` on the worker pool, in order."""
        if self._n_workers <= 1 or len(items) <= 1:
            return [fn(x) for x in items]
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self._n_workers)
        return list(self._pool.map(fn, items))

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_label = _np.zeros((batch_size,) + (
            (self.label_width,) if self.label_width > 1 else ()),
            dtype=_np.float32)
        samples = []
        while len(samples) < batch_size:
            samples.append(self.next_sample())
        payloads = [s for _, s in samples]
        for i, (label, _) in enumerate(samples):
            batch_label[i] = label if _np.ndim(label) else float(label)
        if self._device_augment:
            batch_u8 = _np.empty((batch_size, h, w, c), dtype=_np.uint8)
            swaps = _np.empty(batch_size, bool)
            for i, (arr, swap) in enumerate(self._map_pool(
                    self._decode_geometric_u8, payloads)):
                batch_u8[i] = arr
                swaps[i] = swap
            # the flips are drawn after the batch's samples
            mirror = self._device_aug_params()[2]
            flips = (_np.random.rand(batch_size) < 0.5) if mirror \
                else _np.zeros(batch_size, bool)
            data = self._device_batch(batch_u8, swaps, flips)
        else:
            batch_data = _np.empty((batch_size, c, h, w), dtype=_np.float32)
            for i, arr in enumerate(self._map_pool(self._decode_augment,
                                                   payloads)):
                batch_data[i] = arr
            data = array(batch_data, ctx=self._device)
        return _io.DataBatch([data], [array(batch_label, ctx=self._device)],
                             0, provide_data=self.provide_data,
                             provide_label=self.provide_label)


class ImageRecordIterPy(ImageIter):
    """The iterator behind ``io.ImageRecordIter`` (parity:
    iter_image_recordio_2.cc): crop, mirror and mean/std from its flags."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, mean=(0, 0, 0), std=(1, 1, 1), rand_crop=False,
                 rand_mirror=False, **kwargs):
        mean_arr = _np.array(mean) if any(mean) else None
        std_arr = _np.array(std) if any(s != 1 for s in std) else None
        aug = CreateAugmenter(data_shape, rand_crop=rand_crop,
                              rand_mirror=rand_mirror, mean=mean_arr,
                              std=std_arr)
        super().__init__(batch_size, data_shape, label_width,
                         path_imgrec=path_imgrec, shuffle=shuffle,
                         aug_list=aug, **kwargs)


# the detection pipeline in the image namespace (parity: mx.image.ImageDetIter,
# CreateDetAugmenter, Det*Aug)
from .detection import (DetAugmenter, DetBorrowAug, DetRandomSelectAug,  # noqa: E402,F401
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomPadAug, CreateDetAugmenter,
                        CreateMultiRandCropAugmenter, ImageDetIter)
