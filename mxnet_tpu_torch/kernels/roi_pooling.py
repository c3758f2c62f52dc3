"""ROI max pooling, forward and backward: kernel R (``csrc/roi_pooling.cu``).

Replaces ``_roi_pooling`` (``mxnet_tpu/ops/vision.py:21-57``) and the VJP
JAX derives for it.  ``roi_pool(data, rois, pooled_size, spatial_scale)``
takes data (N, C, H, W) float32 or bfloat16 and rois (R, 5) [batch index,
x1, y1, x2, y2] in image coordinates and returns (R, C, ph, pw), with a
gradient for data.  The ROIs are first cast to data's dtype and scaled and
rounded to integer map coordinates (``roi_coords``) as the JAX op does; a
bin covers rows [y1 + floor(i*rh/ph), y1 + ceil((i+1)*rh/ph)) clipped to
the map (bins may overlap), an empty or non-finite bin gives 0 and no
gradient, and a bin's gradient is split evenly among its tied maxima, as
the gradient of ``jnp.max`` is.

The backward uses no atomics: the kernel gathers, for each data element,
the bins that cover it in the order (ROI, bin row, bin column), the order
in which the plain version adds them, so the kernel's gradient is bitwise
the plain version's and the same on every run.

``roi_pool_reference``/``roi_pool_backward_reference`` are the plain
versions: a loop over ROIs and bins on slices of the map (host-side
coordinates), so they hold at full width what the JAX formula, a masked
max over the whole map per bin, cannot.  The wrapper runs them for CPU
tensors only; for CUDA tensors it launches the kernels or raises.
``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count each direction, ``LAUNCHES``
both.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

LAUNCHES = 0
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD = _build.Entry("roi_pooling", "mxt_roi_pool_fwd",
                    (_P, _P, _P, _P) + (_I,) * 8)
_BWD = _build.Entry("roi_pooling", "mxt_roi_pool_bwd",
                    (_P,) * 6 + (_I,) * 8)
_DTYPES = (torch.float32, torch.bfloat16)


def roi_coords(rois: torch.Tensor, dtype, spatial_scale: float,
               N: int) -> torch.Tensor:
    """(R, 5) int32 [batch, x1, y1, x2, y2] on the map: the ROIs cast to
    ``dtype`` and multiplied by the scale in it (``rois.astype(
    data.dtype)``, so bf16 data rounds the coordinates first), rounded half
    to even; a negative batch index counts from the end and the index is
    clamped into [0, N), as JAX's gather takes it."""
    r = rois.to(dtype)
    scale = torch.tensor(spatial_scale, dtype=dtype, device=r.device)
    b = r[:, 0].to(torch.int32)
    b = torch.where(b < 0, b + N, b).clamp(0, max(N - 1, 0))
    xy = torch.round(r[:, 1:5] * scale).to(torch.int32)
    return torch.cat([b[:, None], xy], dim=1).contiguous()


def _bins(coords, ph, pw, H, W):
    """Per ROI, per bin (i, j): (r, batch, hs, he, ws, we), clipped."""
    for r, (b, x1, y1, x2, y2) in enumerate(coords.tolist()):
        rh, rw = max(y2 - y1 + 1, 1), max(x2 - x1 + 1, 1)
        for i in range(ph):
            hs = max(y1 + (i * rh) // ph, 0)
            he = min(y1 + ((i + 1) * rh + ph - 1) // ph, H)
            for j in range(pw):
                ws = max(x1 + (j * rw) // pw, 0)
                we = min(x1 + ((j + 1) * rw + pw - 1) // pw, W)
                yield r, i, j, b, hs, he, ws, we


def roi_pool_reference(data, coords, ph, pw):
    """(out, count): each bin's max (0 where empty or not finite) and the
    number of elements equal to it (0 there)."""
    N, C, H, W = data.shape
    R = coords.shape[0]
    out = torch.zeros((R, C, ph, pw), dtype=data.dtype, device=data.device)
    count = torch.zeros((R, C, ph, pw), dtype=torch.int32,
                        device=data.device)
    for r, i, j, b, hs, he, ws, we in _bins(coords, ph, pw, H, W):
        if hs >= he or ws >= we:
            continue
        reg = data[b, :, hs:he, ws:we]
        m = reg.amax(dim=(1, 2))
        fin = torch.isfinite(m)
        out[r, :, i, j] = torch.where(fin, m, torch.zeros_like(m))
        count[r, :, i, j] = torch.where(
            fin, (reg == m[:, None, None]).sum(dim=(1, 2)).to(torch.int32),
            torch.zeros_like(count[r, :, i, j]))
    return out, count


def roi_pool_backward_reference(data, coords, out, count, gout):
    """The gradient of data: each bin's output gradient over its count,
    added in float32 to every element equal to the bin's max, bins in the
    order (ROI, row, column); cast to data's dtype at the end."""
    N, C, H, W = data.shape
    _, _, ph, pw = out.shape
    acc = torch.zeros((N, C, H, W), dtype=torch.float32, device=data.device)
    for r, i, j, b, hs, he, ws, we in _bins(coords, ph, pw, H, W):
        if hs >= he or ws >= we:
            continue
        k = count[r, :, i, j]
        val = gout[r, :, i, j].float() / k.float()
        hit = (data[b, :, hs:he, ws:we] == out[r, :, i, j][:, None, None]) \
            & (k > 0)[:, None, None]
        acc[b, :, hs:he, ws:we] += torch.where(
            hit, val[:, None, None], torch.zeros((), device=acc.device))
    return acc.to(data.dtype)


def _check(data, coords):
    if data.device.type != "cuda" or data.dtype not in _DTYPES \
            or data.dim() != 4 or coords.device != data.device \
            or coords.dtype != torch.int32:
        raise MXNetError(
            f"roi_pool takes (N, C, H, W) float32 or bfloat16 data on a CUDA "
            f"device and int32 coordinates on the same device; got "
            f"{data.dtype} {tuple(data.shape)} on {data.device}, coordinates "
            f"{coords.dtype} on {coords.device}")


def roi_pool_forward(data, coords, ph, pw):
    """(out, count) from the kernel for CUDA tensors, else the plain
    version."""
    if data.device.type == "cpu":
        return roi_pool_reference(data, coords, ph, pw)
    _check(data, coords)
    global LAUNCHES, FWD_LAUNCHES
    data = data.contiguous()
    N, C, H, W = data.shape
    R = coords.shape[0]
    out = torch.empty((R, C, ph, pw), dtype=data.dtype, device=data.device)
    count = torch.empty((R, C, ph, pw), dtype=torch.int32,
                        device=data.device)
    _FWD(data.device, data.data_ptr(), coords.data_ptr(), out.data_ptr(),
         count.data_ptr(), N, C, H, W, R, ph, pw,
         int(data.dtype == torch.bfloat16))
    FWD_LAUNCHES += 1
    LAUNCHES += 1
    return out, count


def roi_pool_backward(data, coords, out, count, gout):
    """The gradient of data from the kernel for CUDA tensors, else the
    plain version."""
    if data.device.type == "cpu":
        return roi_pool_backward_reference(data, coords, out, count, gout)
    _check(data, coords)
    global LAUNCHES, BWD_LAUNCHES
    data = data.contiguous()
    gout = gout.to(data.dtype).contiguous()
    N, C, H, W = data.shape
    R, _, ph, pw = out.shape
    gdata = torch.empty_like(data)
    _BWD(data.device, data.data_ptr(), coords.data_ptr(), out.data_ptr(),
         count.data_ptr(), gout.data_ptr(), gdata.data_ptr(), N, C, H, W, R,
         ph, pw, int(data.dtype == torch.bfloat16))
    BWD_LAUNCHES += 1
    LAUNCHES += 1
    return gdata


class ROIPoolFn(torch.autograd.Function):
    """ROI pooling with the kernel (or plain) backward."""

    @staticmethod
    def forward(ctx, data, coords, ph, pw):
        out, count = roi_pool_forward(data, coords, ph, pw)
        ctx.save_for_backward(data, coords, out, count)
        return out

    @staticmethod
    def backward(ctx, gout):
        data, coords, out, count = ctx.saved_tensors
        return (roi_pool_backward(data, coords, out, count, gout), None,
                None, None)


def roi_pool(data, rois, pooled_size, spatial_scale):
    """(R, C, ph, pw) max-pooled ROIs; see the module docstring."""
    ph, pw = (int(v) for v in pooled_size)
    N, C = data.shape[:2]
    if data.device.type == "meta":
        return torch.empty((rois.shape[0], C, ph, pw), dtype=data.dtype,
                           device="meta")
    coords = roi_coords(rois.detach(), data.dtype, spatial_scale, N)
    return ROIPoolFn.apply(data, coords, ph, pw)
