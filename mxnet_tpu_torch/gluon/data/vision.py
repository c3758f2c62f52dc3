"""gluon.data.vision datasets (parity: python/mxnet/gluon/data/vision.py).

``MNIST`` and ``FashionMNIST`` read idx files (gzipped or not), ``CIFAR10``
and ``CIFAR100`` the python-pickle batches, from a local ``root``
directory: files are staged there, nothing is fetched.  Images come back
as (N, H, W, C) float32 in [0, 1] on the current context, labels as int32
numpy arrays.  ``ImageRecordDataset`` (a ``.rec`` of packed images) and
``ImageFolderDataset`` (a folder of class subfolders) decode one image per
item through ``recordio`` (``.npy`` payloads by numpy, JPEG and PNG by cv2
or PIL) into an HWC uint8 tensor on the current context.
"""
from __future__ import annotations

import os
import pickle

import numpy as _np

from ... import recordio
from ...base import MXNetError
from ...io import _read_idx
from ...ndarray import array
from .dataset import Dataset, RecordFileDataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """The MNIST digits: (N, 28, 28, 1) images, labels 0-9."""

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._base_names = (
            ("train-images-idx3-ubyte", "train-labels-idx1-ubyte") if train
            else ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"))
        super().__init__(root, train, transform)

    def _get_data(self):
        paths = []
        for name in self._base_names:
            p = os.path.join(self._root, name)
            if not os.path.exists(p) and os.path.exists(p + ".gz"):
                p = p + ".gz"
            if not os.path.exists(p):
                raise MXNetError(
                    f"{type(self).__name__} file {p} not found; stage the "
                    f"idx files under {self._root}")
            paths.append(p)
        data = _read_idx(paths[0])
        self._data = array(data.reshape(-1, 28, 28, 1).astype(_np.float32)
                           / 255.0)
        self._label = _read_idx(paths[1]).astype(_np.int32)


class FashionMNIST(MNIST):
    """Fashion-MNIST, in MNIST's files and shapes."""

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


def _unpickle(path):
    """A CIFAR batch file: the python pickle the dataset ships (files the
    caller staged, read as trusted input)."""
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _batch_dir(root, sub):
    base = os.path.join(root, sub)
    return base if os.path.isdir(base) else root


class CIFAR10(_DownloadedDataset):
    """CIFAR-10: (N, 32, 32, 3) images, labels 0-9."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        batches = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        base = _batch_dir(self._root, "cifar-10-batches-py")
        data, labels = [], []
        for b in batches:
            p = os.path.join(base, b)
            if not os.path.exists(p):
                raise MXNetError(
                    f"CIFAR10 batch {p} not found; stage cifar-10-batches-py "
                    f"under {self._root}")
            d = _unpickle(p)
            data.append(d[b"data"].reshape(-1, 3, 32, 32))
            labels.append(_np.asarray(d[b"labels"]))
        images = _np.concatenate(data).transpose(0, 2, 3, 1)
        self._data = array(images.astype(_np.float32) / 255.0)
        self._label = _np.concatenate(labels).astype(_np.int32)


class CIFAR100(_DownloadedDataset):
    """CIFAR-100: (N, 32, 32, 3) images, the 100 fine labels or the 20
    coarse ones."""

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=True,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        p = os.path.join(_batch_dir(self._root, "cifar-100-python"),
                         "train" if self._train else "test")
        if not os.path.exists(p):
            raise MXNetError(f"CIFAR100 file {p} not found; stage "
                             f"cifar-100-python under {self._root}")
        d = _unpickle(p)
        images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = b"fine_labels" if self._fine else b"coarse_labels"
        self._data = array(images.astype(_np.float32) / 255.0)
        self._label = _np.asarray(d[key]).astype(_np.int32)


class ImageRecordDataset(RecordFileDataset):
    """(image, label) from a ``.rec`` of packed images; the image as MXNet
    decodes it (BGR with ``flag=1``)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        header, img_bytes = recordio.unpack(super().__getitem__(idx))
        img = array(recordio._imdecode_bytes(img_bytes, self._flag))
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """(image, label) from a folder of class subfolders, the classes in
    sorted order (``synsets``); .jpg, .jpeg and .png files."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((filename, label))

    def __getitem__(self, idx):
        fname, label = self.items[idx]
        with open(fname, "rb") as f:
            img = array(recordio._imdecode_bytes(f.read(), self._flag))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
