"""Toolchain probe kernel: ``o = x + 1`` (``csrc/add_one.cu``).

Replaces ``experiments/flash_probe.py:add_one``.  Built and launched before
any real kernel, so that a toolchain fault is named as one.  Bound: one read
and one write of ``x``; at (8, 128) float32 it is all launch latency.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

LAUNCHES = 0


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def _lib():
    lib = _build.load("add_one")
    lib.mxt_add_one.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_void_p]
    lib.mxt_add_one.restype = ctypes.c_int
    return lib


def add_one(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return add_one_reference(x)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise MXNetError(f"add_one takes a contiguous float32 CUDA tensor, "
                         f"got {x.dtype} on {x.device}")
    global LAUNCHES
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.mxt_add_one(x.data_ptr(), out.data_ptr(), x.numel(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "add_one launch")
    LAUNCHES += 1
    return out
