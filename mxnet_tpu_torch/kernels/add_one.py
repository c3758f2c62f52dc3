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
_ENTRY = _build.Entry("add_one", "mxt_add_one",
                      (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int))


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return add_one_reference(x)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise MXNetError(f"add_one takes a contiguous float32 CUDA tensor, "
                         f"got {x.dtype} on {x.device}")
    global LAUNCHES
    out = torch.empty_like(x)
    _ENTRY(x.device, x.data_ptr(), out.data_ptr(), x.numel())
    LAUNCHES += 1
    return out
