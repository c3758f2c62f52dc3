"""gluon.utils (parity: python/mxnet/gluon/utils.py): ``split_data``,
``split_and_load``, ``clip_global_norm``, ``check_sha1`` and ``download``.

``clip_global_norm`` sums every array's squares on its device and reads
the total back once, where the JAX package reads one float per array: the
same norm, summed in another order (float32 sums per array, float64
across them).  ``download`` returns a file that is already there (with a
matching hash when one is given); it reaches the network only for a file
that is missing, and fails with a pointer to where the file should be
staged.
"""
from __future__ import annotations

import hashlib
import math
import os
import warnings

import torch

from ..base import MXNetError
from ..context import as_device


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; on axis 0 the
    last one takes the remainder."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            f"Too many slices for data with shape {tuple(data.shape)}. "
            f"Arguments are num_slice={num_slice} and "
            f"batch_axis={batch_axis}.")
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {tuple(data.shape)} cannot be evenly split "
            f"into {num_slice} slices along axis {batch_axis}.")
    step = size // num_slice
    if batch_axis == 0:
        return [data[i * step:(i + 1) * step] if i < num_slice - 1 else
                data[i * step:size] for i in range(num_slice)]
    return [data.narrow(batch_axis, i * step, step) for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis``, one slice on each context of
    ``ctx_list`` (an array or list goes to the first context first)."""
    if not isinstance(data, torch.Tensor):
        from ..ndarray import array
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.to(as_device(ctx_list[0]))]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.to(as_device(ctx)) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so that their joint 2-norm is at most
    ``max_norm``; returns the norm before scaling, as a Python float."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    device = arrays[0].device
    with torch.no_grad():
        sums = torch.stack([torch.sum(torch.square(a.detach().float()))
                            .to(device) for a in arrays])
        total_norm = math.sqrt(sums.double().sum().item())
    if math.isnan(total_norm) or math.isinf(total_norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for arr in arrays:
                arr.mul_(scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """The local file for ``url`` (under ``path``, a directory or a file
    name): returned as it is when present and its hash matches; fetched
    only when it is missing (a machine with no network fails here, naming
    where to stage it)."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if not overwrite and os.path.exists(fname) and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    import urllib.request
    try:
        urllib.request.urlretrieve(url, fname)
    except OSError as e:
        raise MXNetError(
            f"download of {url} failed ({e}); on a machine with no network "
            f"stage the file at {fname}") from None
    if sha1_hash and not check_sha1(fname, sha1_hash):
        raise UserWarning(f"File {fname} is downloaded but the content hash "
                          "does not match.")
    return fname
