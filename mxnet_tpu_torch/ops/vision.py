"""Vision ops (parity: ``mxnet_tpu/ops/vision.py``): ``ROIPooling``,
``GridGenerator``, ``BilinearSampler``, ``SpatialTransformer``, ``Crop``,
``Correlation``.

``ROIPooling`` is kernel R (``kernels/roi_pooling.py``), forward and
backward: the JAX formula, a masked max over the whole map per bin, does
not fit a card at Faster R-CNN's width.  The samplers follow the JAX
formula (``_bilinear_sample``): the grid in [-1, 1] mapped to pixels, the
four neighbours gathered with zeros outside the map and weighted
``(1 - wy)(1 - wx)``, ... in that order; not ``F.grid_sample``, whose
out-of-range handling and gradients are another formula.
"""
from __future__ import annotations

import torch

from ..base import Arg, MXNetError
from ..kernels import roi_pooling as _roi
from .registry import register


@register("ROIPooling", input_names=("data", "rois"),
          args=[Arg("pooled_size", "shape", required=True),
                Arg("spatial_scale", float, required=True)])
def _roi_pooling(p, data, rois):
    """Max-pool each ROI of rois (R, 5) [batch index, x1, y1, x2, y2]
    (image coordinates) over data (N, C, H, W) into (R, C, ph, pw)."""
    return _roi.roi_pool(data, rois, p["pooled_size"], p["spatial_scale"])


def _linspace(n, dtype, device):
    """``jnp.linspace(-1, 1, n)``: -1 * (1 - t) + 1 * t at t = i / (n-1),
    then the end point."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=dtype, device=device)
    t = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
    out = -1.0 * (1 - t) + 1.0 * t
    return torch.cat([out, torch.ones(1, dtype=dtype, device=device)])


def _affine_grid(theta, h, w):
    xs = _linspace(w, theta.dtype, theta.device)
    ys = _linspace(h, theta.dtype, theta.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])
    out = torch.einsum("nij,jk->nik", theta.reshape(-1, 2, 3), base)
    return out.reshape(-1, 2, h, w)


@register("GridGenerator", input_names=("data",),
          args=[Arg("transform_type", str, required=True),
                Arg("target_shape", "shape", ())])
def _grid_generator(p, data):
    """``affine``: (N, 6) -> the (N, 2, h, w) grid of target pixels mapped
    by each 2x3 matrix; ``warp``: a (N, 2, H, W) flow field -> the absolute
    sampling grid in [-1, 1]."""
    if p["transform_type"] == "affine":
        h, w = p["target_shape"]
        if data.device.type == "meta":
            return torch.empty((data.numel() // 6, 2, h, w),
                               dtype=data.dtype, device="meta")
        return _affine_grid(data, h, w)
    if p["transform_type"] == "warp":
        N, _, H, W = data.shape
        xs = torch.arange(W, dtype=data.dtype, device=data.device)
        ys = torch.arange(H, dtype=data.dtype, device=data.device)
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        x = (data[:, 0] + gx) * 2 / max(W - 1, 1) - 1
        y = (data[:, 1] + gy) * 2 / max(H - 1, 1) - 1
        return torch.stack([x, y], dim=1)
    raise MXNetError(f"unknown transform_type {p['transform_type']}")


def _bilinear_sample(data, grid):
    """data (N, C, H, W) sampled at grid (N, 2, Ho, Wo) in [-1, 1] ->
    (N, C, Ho, Wo), the JAX package's ``_bilinear_sample`` per image."""
    N, C, H, W = data.shape
    x = (grid[:, 0] + 1) * (W - 1) / 2                    # (N, Ho, Wo)
    y = (grid[:, 1] + 1) * (H - 1) / 2
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = data.reshape(-1)
    plane = (torch.arange(N * C, device=data.device).reshape(N, C, 1, 1)
             * (H * W))

    def gather(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        yi = yy.to(torch.int64).clamp(0, H - 1)
        xi = xx.to(torch.int64).clamp(0, W - 1)
        vals = flat[plane + (yi * W + xi)[:, None]]
        return torch.where(ok[:, None], vals,
                           torch.zeros((), dtype=vals.dtype,
                                       device=vals.device))

    wy, wx = wy[:, None], wx[:, None]
    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)


@register("BilinearSampler", input_names=("data", "grid"))
def _bilinear_sampler(p, data, grid):
    """Sample data (N, C, H, W) at grid (N, 2, Ho, Wo) in [-1, 1]; zero
    outside the map."""
    if data.device.type == "meta":
        return torch.empty(data.shape[:2] + grid.shape[2:],
                           dtype=data.dtype, device="meta")
    return _bilinear_sample(data, grid)


@register("SpatialTransformer", input_names=("data", "loc"),
          args=[Arg("target_shape", "shape", ()),
                Arg("transform_type", str, "affine"),
                Arg("sampler_type", str, "bilinear")])
def _spatial_transformer(p, data, loc):
    """Affine spatial transformer: the ``affine`` grid of loc (N, 6) at
    target_shape, then ``BilinearSampler``."""
    h, w = p["target_shape"]
    if data.device.type == "meta":
        return torch.empty(data.shape[:2] + (h, w), dtype=data.dtype,
                           device="meta")
    return _bilinear_sample(data, _affine_grid(loc, h, w))


@register("Crop", input_names=("args",), variadic=True,
          args=[Arg("num_args", int, required=True),
                Arg("offset", "shape", (0, 0)),
                Arg("h_w", "shape", (0, 0)), Arg("center_crop", bool, False)])
def _crop_op(p, *xs):
    """Crop x (N, C, H, W) to the second input's spatial shape, or to
    ``h_w``, at ``offset`` or centred."""
    x = xs[0]
    if len(xs) == 2:
        th, tw = xs[1].shape[2], xs[1].shape[3]
    else:
        th, tw = p["h_w"]
    H, W = x.shape[2], x.shape[3]
    if p["center_crop"]:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = p["offset"]
    return x[:, :, y0:y0 + th, x0:x0 + tw]


@register("Correlation", input_names=("data1", "data2"),
          args=[Arg("kernel_size", int, 1), Arg("max_displacement", int, 1),
                Arg("stride1", int, 1), Arg("stride2", int, 1),
                Arg("pad_size", int, 0), Arg("is_multiply", bool, True)])
def _correlation(p, a, b):
    """FlowNet's correlation as the JAX op computes it: for each
    displacement (dy, dx) in [-d, d] by stride2, the channel mean of a
    times b rolled by it (or their absolute difference), over the padded
    maps, cropped back to (H, W).  Like the JAX op it reads neither
    kernel_size nor stride1."""
    pad, d, s2 = p["pad_size"], p["max_displacement"], p["stride2"]
    N, C, H, W = a.shape
    offsets = [(dy, dx) for dy in range(-d, d + 1, s2)
               for dx in range(-d, d + 1, s2)]
    if a.device.type == "meta":
        return torch.empty((N, len(offsets), H, W), dtype=a.dtype,
                           device="meta")
    apad = torch.nn.functional.pad(a, (pad, pad, pad, pad))
    bpad = torch.nn.functional.pad(b, (pad, pad, pad, pad))
    outs = []
    for dy, dx in offsets:
        shifted = torch.roll(bpad, (-dy, -dx), dims=(2, 3))
        prod = apad * shifted if p["is_multiply"] else \
            torch.abs(apad - shifted)
        outs.append(torch.mean(prod, dim=1))
    out = torch.stack(outs, dim=1)
    return out[:, :, pad:pad + H, pad:pad + W]
