"""Greedy non-maximum suppression over score-sorted boxes: kernel N
(``csrc/nms.cu``).

Replaces the sequential ``lax.fori_loop`` of the JAX package's
``_multibox_detection`` (``mxnet_tpu/ops/contrib.py:277-289``) and
``_proposal`` (``:370-389``), which PyTorch would run as one Python step and
several launches per box.  ``nms_keep`` takes B samples of K boxes sorted
by descending score, (B, K, 4) float32 corners, their class ids (B, K)
float32 and the boxes alive before suppression (B, K) bool, and returns the
boxes alive after it: box i, if still alive at its turn, kills every later
box of its class (any class unless ``class_aware``) whose IoU with it
exceeds ``threshold``; ``pixel`` takes widths as x2 - x1 + 1 (Proposal's
convention), else x2 - x1 (MultiBoxDetection's).

``nms_reference`` is the loop itself in PyTorch, over the same IoU formula
as separate tensor ops; the kernel rounds each operation as they do, so
the two give the same keep set bit for bit.  The wrapper runs the plain
version for CPU tensors only; for CUDA tensors it launches the kernel (one
launch = one call, its two kernels for all B samples) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

LAUNCHES = 0
_ENTRY = _build.Entry(
    "nms", "mxt_nms",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int, ctypes.c_int))


def pair_iou(a: torch.Tensor, b: torch.Tensor, pixel: bool) -> torch.Tensor:
    """IoU of corner boxes a and b (broadcast over leading axes), as the
    JAX package computes it: ``_iou_corner`` (``pixel=False``) or
    Proposal's ``iou_pixel`` (widths + 1)."""
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    if pixel:
        inter = (ix2 - ix1 + 1).clamp_min(0) * (iy2 - iy1 + 1).clamp_min(0)
        area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
        area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    else:
        inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
        area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * \
            (a[..., 3] - a[..., 1]).clamp_min(0)
        area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * \
            (b[..., 3] - b[..., 1]).clamp_min(0)
    return inter / (area_a + area_b - inter).clamp_min(1e-10)


def nms_reference(boxes, cls, alive, threshold, pixel=False,
                  class_aware=False):
    """The JAX loop: for each i in order, suppress the later boxes that the
    still-alive box i overlaps.  The pair suppressions are computed first
    (B x K x K, one sample's IoUs at a time), then the loop reads one row
    of every sample a step."""
    B, K = alive.shape
    later = torch.ones(K, K, dtype=torch.bool, device=alive.device).triu(1)
    sup = torch.empty((B, K, K), dtype=torch.bool, device=alive.device)
    for s in range(B):
        sup[s] = (pair_iou(boxes[s, :, None, :], boxes[s, None, :, :], pixel)
                  > threshold) & later
        if class_aware:
            sup[s] &= cls[s, :, None] == cls[s, None, :]
    alive = alive.clone()
    for i in range(K):
        alive &= ~(sup[:, i] & alive[:, i:i + 1])
    return alive


def nms_keep(boxes, cls, alive, threshold, pixel=False, class_aware=False):
    """Boxes alive after greedy suppression; see the module docstring."""
    if boxes.device.type == "cpu":
        return nms_reference(boxes, cls, alive, threshold, pixel,
                             class_aware)
    if boxes.device.type == "meta":
        return torch.empty(alive.shape, dtype=torch.bool, device="meta")
    B, K = alive.shape
    if boxes.device.type != "cuda" or boxes.dtype != torch.float32 \
            or tuple(boxes.shape) != (B, K, 4) or alive.dtype != torch.bool \
            or (class_aware and (cls is None or cls.dtype != torch.float32
                                 or tuple(cls.shape) != (B, K))):
        raise MXNetError(
            f"nms_keep takes (B, K, 4) float32 boxes, (B, K) float32 class "
            f"ids and a (B, K) bool mask on one CUDA device; got boxes "
            f"{boxes.dtype} {tuple(boxes.shape)} on {boxes.device}, alive "
            f"{alive.dtype} {tuple(alive.shape)}")
    global LAUNCHES
    boxes = boxes.contiguous()
    cls = cls.contiguous() if class_aware else None
    alive_in = alive.contiguous().to(torch.uint8)
    out = torch.empty_like(alive_in)
    words = (K + 63) // 64
    mask = torch.empty((B, K, words), dtype=torch.int64, device=boxes.device)
    _ENTRY(boxes.device, boxes.data_ptr(),
           cls.data_ptr() if class_aware else 0, alive_in.data_ptr(),
           out.data_ptr(), mask.data_ptr(), B, K, float(threshold),
           int(bool(pixel)), int(bool(class_aware)))
    LAUNCHES += 1
    return out.bool()
