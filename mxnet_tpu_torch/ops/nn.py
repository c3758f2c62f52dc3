"""Neural-network operators (parity: ``mxnet_tpu/ops/nn.py``).

``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``BatchNorm``, ``LayerNorm``, ``InstanceNorm``, ``LRN``, ``Activation``,
``LeakyReLU``, ``Dropout``, ``UpSampling``, ``L2Normalization``,
``softmax`` / ``log_softmax`` with ``temperature``, ``SoftmaxActivation``,
``softmax_cross_entropy``, and the loss outputs (``SoftmaxOutput``, the
three ``*RegressionOutput``s, ``MakeLoss``, ``SVMOutput``) as
``torch.autograd.Function``s with MXNet's folded gradients.  What the JAX package left to XLA
goes to PyTorch's own ops: a dense product to ``torch.matmul`` (cuBLAS on
the card), convolutions and pooling to ``torch.nn.functional`` (cuDNN),
batch normalisation to ``F.batch_norm``.  The layout is NCHW: the JAX
package's channels-last pass is for the TPU and is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import Arg, MXNetError
from .elemwise import _maximum, _softrelu, _softsign
from .registry import register
from .. import random as _random

_ACTIVATIONS = {"relu": lambda x: _maximum(x, 0),
                "sigmoid": torch.sigmoid, "tanh": torch.tanh,
                "softrelu": _softrelu, "softsign": _softsign}


def _tup(v, n, default=1):
    if not v:
        return (default,) * n
    return tuple(v) if len(v) == n else tuple(v) * n


def _rank(kernel):
    n = len(kernel)
    if n not in (1, 2, 3):
        raise MXNetError(f"unsupported conv kernel rank {n}")
    return n


@register("FullyConnected", input_names=("data", "weight", "bias"),
          args=[Arg("num_hidden", int, required=True), Arg("no_bias", bool, False),
                Arg("flatten", bool, True)])
def _fully_connected(p, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if p["flatten"] else data
    out = torch.matmul(x, weight.t())
    if not p["no_bias"]:
        out = out + bias
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Convolution", input_names=("data", "weight", "bias"),
          aliases=("Convolution_v1",),
          args=[Arg("kernel", "shape", required=True), Arg("stride", "shape", ()),
                Arg("dilate", "shape", ()), Arg("pad", "shape", ()),
                Arg("num_filter", int, required=True), Arg("num_group", int, 1),
                Arg("no_bias", bool, False), Arg("layout", str, None),
                Arg("workspace", int, 1024), Arg("cudnn_tune", str, None),
                Arg("cudnn_off", bool, False)])
def _convolution(p, data, weight, bias=None):
    """NCHW convolution, 1-D to 3-D, with groups and dilation: one
    ``F.conv*d`` (cuDNN on the card), as the JAX op is one
    ``lax.conv_general_dilated``."""
    n = _rank(p["kernel"])
    return _CONV[n](data, weight, None if p["no_bias"] else bias,
                    stride=_tup(p["stride"], n), padding=_tup(p["pad"], n, 0),
                    dilation=_tup(p["dilate"], n), groups=p["num_group"])


@register("Deconvolution", input_names=("data", "weight", "bias"),
          args=[Arg("kernel", "shape", required=True), Arg("stride", "shape", ()),
                Arg("dilate", "shape", ()), Arg("pad", "shape", ()),
                Arg("adj", "shape", ()), Arg("target_shape", "shape", ()),
                Arg("num_filter", int, required=True), Arg("num_group", int, 1),
                Arg("no_bias", bool, True), Arg("layout", str, None),
                Arg("workspace", int, 512), Arg("cudnn_tune", str, None),
                Arg("cudnn_off", bool, False)])
def _deconvolution(p, data, weight, bias=None):
    """Transposed convolution: ``F.conv_transpose*d``, whose weight layout
    (in, out/group, *kernel) is MXNet's.  ``adj`` is the output padding;
    ``target_shape`` is accepted and ignored, as by the JAX op."""
    n = _rank(p["kernel"])
    return _CONV_T[n](data, weight, None if p["no_bias"] else bias,
                      stride=_tup(p["stride"], n),
                      padding=_tup(p["pad"], n, 0),
                      output_padding=_tup(p["adj"], n, 0),
                      groups=p["num_group"], dilation=_tup(p["dilate"], n))


_POOL = {"max": {2: F.max_pool2d, 3: F.max_pool3d},
         "avg": {2: F.avg_pool2d, 3: F.avg_pool3d}}


@register("Pooling", input_names=("data",), aliases=("Pooling_v1",),
          args=[Arg("kernel", "shape", ()), Arg("pool_type", str, "max"),
                Arg("global_pool", bool, False), Arg("stride", "shape", ()),
                Arg("pad", "shape", ()), Arg("pooling_convention", str, "valid"),
                Arg("cudnn_off", bool, False)])
def _pooling(p, x):
    """Max, average and sum pooling.  ``pooling_convention="full"`` adds
    ``(-size) % stride`` of padding at the high end, and an average divides
    by the whole kernel volume, padding included, as the JAX op does.
    Where torch's own padding cannot say that (torch's ``ceil_mode`` drops
    a last window that starts in the padding, and caps padding at half
    the kernel), the padding is explicit: ``-inf`` for max, 0 otherwise.
    1-D pooling runs as 2-D over a unit axis."""
    kind = p["pool_type"]
    if kind not in ("max", "avg", "sum"):
        raise MXNetError(f"unknown pool_type {kind}")
    if p["global_pool"]:
        dims = tuple(range(2, x.dim()))
        reduce = {"max": torch.amax, "avg": torch.mean, "sum": torch.sum}[kind]
        return reduce(x, dim=dims, keepdim=True)
    n = x.dim() - 2
    k, stride = _tup(p["kernel"], n), _tup(p["stride"], n)
    pad = _tup(p["pad"], n, 0)
    if n == 1:
        x, k, stride, pad = x.unsqueeze(2), (1,) + k, (1,) + stride, (0,) + pad
    extra = [(-(x.shape[2 + i] + 2 * pad[i] - k[i])) % stride[i]
             if p["pooling_convention"] == "full" else 0
             for i in range(len(k))]
    if any(extra) or any(2 * q > ki for q, ki in zip(pad, k)):
        widths = []
        for q, e in zip(reversed(pad), reversed(extra)):
            widths += [q, q + e]
        x = F.pad(x, widths, value=-math.inf if kind == "max" else 0.0)
        pad = (0,) * len(k)
    if kind == "max":
        out = _POOL["max"][len(k)](x, k, stride, pad)
    else:
        out = _POOL["avg"][len(k)](x, k, stride, pad, count_include_pad=True,
                                   divisor_override=1 if kind == "sum" else None)
    return out.squeeze(2) if n == 1 else out


@register("BatchNorm", input_names=("data", "gamma", "beta", "moving_mean",
                                    "moving_var"),
          args=[Arg("eps", float, 1e-3), Arg("momentum", float, 0.9),
                Arg("fix_gamma", bool, True), Arg("use_global_stats", bool, False),
                Arg("output_mean_var", bool, False), Arg("axis", int, 1),
                Arg("cudnn_off", bool, False)],
          num_outputs=3, aux_inputs=[3, 4], takes_is_train=True,
          f32_inputs=(1, 2, 3, 4), aliases=("BatchNorm_v1",))
def _batch_norm(p, x, gamma, beta, mov_mean, mov_var):
    """Returns (out, mean, var) and the updated (moving_mean, moving_var).

    MXNet's semantics, not torch's: ``momentum`` is the share the moving
    statistic keeps (``moving * m + batch * (1 - m)``), the moving variance
    is the biased one, and the statistics are float32 whatever the data's
    dtype; the update is computed in float32 and stored in the moving
    statistic's dtype.  ``F.batch_norm`` normalises (cuDNN's kernels on the
    card, which take float32 scale and shift under bfloat16 data) and
    hands back the batch mean and unbiased variance through two float32
    scratch buffers (``momentum=1``).  In inference, or with
    ``use_global_stats``, the moving statistics normalise and stay as they
    are.  The mean and variance outputs carry no gradient."""
    ax = p["axis"] % x.dim()
    if ax != 1:
        x = x.movedim(ax, 1)
    g = torch.ones_like(gamma) if p["fix_gamma"] else gamma
    w, b = g.float(), beta.float()
    if p["__is_train__"] and not p["use_global_stats"]:
        count = x.numel() // x.shape[1]
        mean = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
        var = torch.zeros_like(mean)
        out = F.batch_norm(x, mean, var, w, b, training=True, momentum=1.0,
                           eps=p["eps"])
        var = var * ((count - 1) / count)
        m = p["momentum"]
        with torch.no_grad():
            new_mm = (mov_mean.float() * m + mean * (1 - m)).to(mov_mean.dtype)
            new_mv = (mov_var.float() * m + var * (1 - m)).to(mov_var.dtype)
    else:
        mean, var, new_mm, new_mv = mov_mean, mov_var, mov_mean, mov_var
        out = F.batch_norm(x, mov_mean.float(), mov_var.float(), w, b,
                           training=False, eps=p["eps"])
    if ax != 1:
        out = out.movedim(1, ax)
    return (out, mean.detach().to(x.dtype), var.detach().to(x.dtype),
            new_mm, new_mv)


@register("LayerNorm", input_names=("data", "gamma", "beta"),
          args=[Arg("axis", int, -1), Arg("eps", float, 1e-5),
                Arg("output_mean_var", bool, False)],
          num_outputs=3)
def _layer_norm(p, x, gamma, beta):
    """Returns (out, mean, var) with the biased variance, as jnp.var."""
    ax = p["axis"] % x.dim()
    mean = torch.mean(x, dim=ax, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=ax, keepdim=True)
    inv = torch.rsqrt(var + p["eps"])
    bshape = tuple(x.shape[ax] if i == ax else 1 for i in range(x.dim()))
    out = (x - mean) * inv * gamma.reshape(bshape) + beta.reshape(bshape)
    return out, torch.squeeze(mean, ax), torch.squeeze(var, ax)


@register("InstanceNorm", input_names=("data", "gamma", "beta"),
          args=[Arg("eps", float, 1e-3)])
def _instance_norm(p, x, gamma, beta):
    """Normalise each (sample, channel) over its spatial axes, biased
    variance."""
    var, mean = torch.var_mean(x, dim=tuple(range(2, x.dim())), correction=0,
                               keepdim=True)
    bshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    return ((x - mean) * torch.rsqrt(var + p["eps"]) * gamma.reshape(bshape)
            + beta.reshape(bshape))


@register("LRN", input_names=("data",),
          args=[Arg("alpha", float, 1e-4), Arg("beta", float, 0.75),
                Arg("knorm", float, 2.0), Arg("nsize", int, required=True)])
def _lrn(p, x):
    """Cross-channel local response normalisation over an odd window of
    ``nsize`` channels, summed as shifted channel slices (the JAX op's
    form)."""
    if p["nsize"] % 2 == 0:
        raise MXNetError(
            f"LRN nsize must be odd (got {p['nsize']}): the window is "
            "centered on each channel")
    half, C = p["nsize"] // 2, x.shape[1]
    sq = F.pad(torch.square(x).movedim(1, -1), (half, half)).movedim(-1, 1)
    ssum = sq[:, 0:C]
    for i in range(1, p["nsize"]):
        ssum = ssum + sq[:, i:i + C]
    return x / torch.pow(p["knorm"] + p["alpha"] / p["nsize"] * ssum,
                         p["beta"])


@register("Activation", input_names=("data",),
          args=[Arg("act_type", str, required=True)])
def _activation(p, x):
    fn = _ACTIVATIONS.get(p["act_type"])
    if fn is None:
        raise MXNetError(f"unknown act_type {p['act_type']}")
    return fn(x)


@register("LeakyReLU", input_names=("args",), variadic=True,
          args=[Arg("act_type", str, "leaky"), Arg("slope", float, 0.25),
                Arg("lower_bound", float, 0.125), Arg("upper_bound", float, 0.334)])
def _leaky_relu(p, x, gamma=None):
    """leaky, elu, prelu (a learned slope per channel), selu; rrelu with
    the midpoint slope, as the reference in inference."""
    t = p["act_type"]
    if t == "leaky":
        return torch.where(x > 0, x, p["slope"] * x)
    if t == "elu":
        return torch.where(x > 0, x, p["slope"] * torch.expm1(x))
    if t == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) \
            if gamma.dim() == 1 and x.dim() > 1 else gamma
        return torch.where(x > 0, x, g * x)
    if t == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
    if t == "rrelu":
        slope = (p["lower_bound"] + p["upper_bound"]) / 2.0
        return torch.where(x > 0, x, slope * x)
    raise MXNetError(f"unknown act_type {t}")


@register("Dropout", input_names=("data",),
          args=[Arg("p", float, 0.5), Arg("mode", str, "training"),
                Arg("axes", "shape", ())],
          takes_is_train=True)
def _dropout(p, x):
    """Inverted dropout in training (or always, with ``mode="always"``),
    the identity otherwise.  The mask is drawn from the port's generator
    for the tensor's device (``random.generator``), which ``random.seed``
    resets; it cannot reproduce the JAX package's bits.  ``axes`` share one
    mask value along those axes."""
    rate = p["p"]
    if rate <= 0.0 or not (p["__is_train__"] or p["mode"] == "always"):
        return x
    if x.device.type == "meta":
        return torch.empty_like(x)
    shape = tuple(1 if i in p["axes"] else s for i, s in enumerate(x.shape))
    keep = torch.rand(shape, generator=_random.generator(x.device),
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


@register("softmax", input_names=("data",),
          args=[Arg("axis", int, -1), Arg("temperature", float, None)])
def _softmax(p, x):
    t = p["temperature"] or 1.0
    return torch.softmax(x / t, dim=p["axis"])


@register("SoftmaxActivation", input_names=("data",),
          args=[Arg("mode", str, "instance")])
def _softmax_activation(p, x):
    """Softmax over the channels (axis 1) in 'channel' mode, else over
    all of each instance's values."""
    if p["mode"] == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


@register("softmax_cross_entropy", input_names=("data", "label"),
          f32_inputs=(1,))
def _softmax_cross_entropy(p, data, label):
    """The summed cross-entropy of each row's softmax at its label: a
    (1,)-free scalar, as the JAX package returns it."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.sum(torch.gather(logp, -1, label.to(torch.int64)[:, None]))


@register("L2Normalization", input_names=("data",),
          args=[Arg("eps", float, 1e-10), Arg("mode", str, "instance")])
def _l2_normalization(p, x):
    """x / sqrt(sum(x^2) + eps) over each instance ('instance'), the
    channels ('channel') or each channel's positions ('spatial')."""
    dims = {"instance": tuple(range(1, x.dim())), "channel": (1,)}.get(
        p["mode"], tuple(range(2, x.dim())))
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True)
                          + p["eps"])


@register("log_softmax", input_names=("data",),
          args=[Arg("axis", int, -1), Arg("temperature", float, None)])
def _log_softmax(p, x):
    t = p["temperature"] or 1.0
    return torch.log_softmax(x / t, dim=p["axis"])


@register("UpSampling", input_names=("args",), variadic=True,
          args=[Arg("scale", int, required=True), Arg("sample_type", str, "nearest"),
                Arg("num_args", int, 1), Arg("workspace", int, 512),
                Arg("multi_input_mode", str, "concat"), Arg("num_filter", int, 0)])
def _upsampling(p, *xs):
    """Nearest (each pixel repeated ``scale`` times along H and W) or
    bilinear (half-pixel centres, as ``jax.image.resize``) upsampling of
    each input, concatenated on the channel axis when there are several."""
    s = p["scale"]
    if p["sample_type"] == "nearest":
        outs = [x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
                for x in xs]
    else:
        outs = [F.interpolate(x, scale_factor=s, mode="bilinear",
                              align_corners=False) for x in xs]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Loss-output ops with MXNet's folded gradient (parity: the JAX package's
# jax.custom_vjp definitions, mxnet_tpu/ops/nn.py:473-586)
# ---------------------------------------------------------------------------
def _softmax_output_fwd(p, x):
    if p["multi_output"]:
        return torch.softmax(x, dim=1)
    if p["preserve_shape"]:
        return torch.softmax(x, dim=-1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward: the softmax in the input's dtype.  Backward:
    ``(softmax - onehot(label)) * grad_scale``, rows whose label is
    ``ignore_label`` zeroed under ``use_ignore``, divided by the batch or
    by the valid rows under ``normalization``; the head gradient is
    ignored unless ``out_grad``, and the label gets a zero gradient.  The
    one-hot is never built: each row's label entry is decremented in place
    (a label out of range subtracts nothing, as ``jax.nn.one_hot`` gives
    it a zero row)."""

    @staticmethod
    def forward(ctx, data, label, p):
        out = _softmax_output_fwd(p, data)
        ctx.save_for_backward(out, label)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        p = ctx.p
        ax = 1 if p["multi_output"] else out.dim() - 1
        nclass = out.shape[ax]
        lab = label.to(torch.int64)
        hit = ((lab >= 0) & (lab < nclass)).to(out.dtype)
        grad = out.clone()
        grad.scatter_add_(ax, lab.clamp(0, nclass - 1).unsqueeze(ax),
                          -hit.unsqueeze(ax))
        valid = torch.ones_like(lab, dtype=out.dtype)
        if p["use_ignore"]:
            valid = (lab != int(p["ignore_label"])).to(out.dtype)
            grad = grad * valid.unsqueeze(ax)
        scale = p["grad_scale"]
        if p["normalization"] == "batch":
            scale = scale / out.shape[0]
        elif p["normalization"] == "valid":
            scale = scale / torch.clamp(valid.sum(), min=1.0)
        grad = grad * scale
        if p["out_grad"]:
            grad = grad * g
        return grad.to(out.dtype), torch.zeros_like(label), None


@register("SoftmaxOutput", input_names=("data", "label"), aliases=("Softmax",),
          f32_inputs=(1,),
          args=[Arg("grad_scale", float, 1.0), Arg("ignore_label", float, -1.0),
                Arg("multi_output", bool, False), Arg("use_ignore", bool, False),
                Arg("preserve_shape", bool, False),
                Arg("normalization", str, "null"),
                Arg("out_grad", bool, False), Arg("smooth_alpha", float, 0.0)])
def _softmax_output(p, data, label):
    """Parity: src/operator/softmax_output-inl.h.  ``smooth_alpha`` is
    accepted and unused, as in the JAX package."""
    return _SoftmaxOutputFn.apply(data, label, dict(p))


class _RegressionFn(torch.autograd.Function):
    """Forward ``fwd(data)``; backward ``bwd(out, label) * grad_scale /
    num_output`` (the label's size per sample), the head gradient
    ignored, the label's gradient zero."""

    @staticmethod
    def forward(ctx, data, label, fwd, bwd, scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.bwd, ctx.scale = bwd, scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num_output = math.prod(label.shape[1:])
        grad = ctx.bwd(out, label.reshape(out.shape)) * (ctx.scale / num_output)
        return grad.to(out.dtype), torch.zeros_like(label), None, None, None


def _make_regression(name, fwd, bwd):
    @register(name, input_names=("data", "label"),
              args=[Arg("grad_scale", float, 1.0)])
    def op(p, data, label):
        """Parity: src/operator/regression_output-inl.h:75-97."""
        return _RegressionFn.apply(data, label, fwd, bwd, p["grad_scale"])
    return op


_make_regression("LinearRegressionOutput", lambda x: x, lambda o, l: o - l)
_make_regression("LogisticRegressionOutput", torch.sigmoid,
                 lambda o, l: o - l)
_make_regression("MAERegressionOutput", lambda x: x,
                 lambda o, l: torch.sign(o - l))


class _MakeLossFn(torch.autograd.Function):
    """The identity forward; the backward a constant ``grad_scale`` (over
    the batch under ``normalization="batch"``), the head gradient
    ignored."""

    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None


@register("MakeLoss", input_names=("data",),
          args=[Arg("grad_scale", float, 1.0), Arg("valid_thresh", float, 0.0),
                Arg("normalization", str, "null")])
def _make_loss_legacy(p, data):
    """Parity: src/operator/make_loss.cc."""
    scale = p["grad_scale"]
    if p["normalization"] == "batch":
        scale = scale / data.shape[0]
    return _MakeLossFn.apply(data, scale)


class _SVMOutputFn(torch.autograd.Function):
    """The identity forward; the backward MXNet's one-vs-all hinge gradient
    (src/operator/svm_output.cc L1_SVM/L2_SVM), the head gradient ignored,
    the label's gradient zero."""

    @staticmethod
    def forward(ctx, data, label, p):
        ctx.save_for_backward(data, label)
        ctx.p = p
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        p = ctx.p
        flat = out.reshape(out.shape[0], -1)
        m, reg = p["margin"], p["regularization_coefficient"]
        classes = torch.arange(flat.shape[1], device=flat.device)
        onehot = (label.to(torch.int64).reshape(-1, 1) == classes).to(
            flat.dtype)                 # a label out of range: a zero row
        if p["use_linear"]:                                   # L1-SVM
            g_true = -(m > flat).to(flat.dtype) * reg
            g_other = (m > -flat).to(flat.dtype) * reg
        else:                                                 # L2-SVM
            g_true = torch.where(m > flat, -2.0 * reg * (m - flat), 0.0)
            g_other = torch.where(m > -flat, 2.0 * reg * (m + flat), 0.0)
        grad = onehot * g_true + (1 - onehot) * g_other
        return grad.reshape(out.shape), torch.zeros_like(label), None


@register("SVMOutput", input_names=("data", "label"), f32_inputs=(1,),
          args=[Arg("margin", float, 1.0),
                Arg("regularization_coefficient", float, 1.0),
                Arg("use_linear", bool, False)])
def _svm_output(p, data, label):
    """Parity: src/operator/svm_output.cc: identity forward, one-vs-all
    hinge backward (L2-SVM by default, L1 with ``use_linear``)."""
    return _SVMOutputFn.apply(data, label, dict(p))
