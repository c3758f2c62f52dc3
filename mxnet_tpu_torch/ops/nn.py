"""Neural-network operators of the serving slice.

The counterpart of part of ``mxnet_tpu/ops/nn.py``: ``FullyConnected``,
``LayerNorm``, ``Activation``, ``Dropout`` (inference), and
``softmax`` / ``log_softmax`` with ``temperature``.  A dense
matrix product goes to ``torch.matmul`` (cuBLAS on the card), as the JAX
package left it to XLA.
"""
from __future__ import annotations

import torch

from ..base import Arg, MXNetError
from .elemwise import _maximum, _softrelu, _softsign
from .registry import register

_ACTIVATIONS = {"relu": lambda x: _maximum(x, 0),
                "sigmoid": torch.sigmoid, "tanh": torch.tanh,
                "softrelu": _softrelu, "softsign": _softsign}


@register("FullyConnected", input_names=("data", "weight", "bias"),
          args=[Arg("num_hidden", int, required=True), Arg("no_bias", bool, False),
                Arg("flatten", bool, True)])
def _fully_connected(p, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if p["flatten"] else data
    out = torch.matmul(x, weight.t())
    if not p["no_bias"]:
        out = out + bias
    return out


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


@register("Activation", input_names=("data",),
          args=[Arg("act_type", str, required=True)])
def _activation(p, x):
    fn = _ACTIVATIONS.get(p["act_type"])
    if fn is None:
        raise MXNetError(f"unknown act_type {p['act_type']}")
    return fn(x)


@register("Dropout", input_names=("data",),
          args=[Arg("p", float, 0.5), Arg("mode", str, "training"),
                Arg("axes", "shape", ())],
          takes_is_train=True)
def _dropout(p, x):
    """The identity at inference and under ``record(train_mode=False)``.
    Training-mode dropout (random masks from the port's generators, which
    cannot give the JAX package's bits) is not ported yet: the
    TransformerLM trains with dropout 0."""
    if p["p"] > 0.0 and (p["__is_train__"] or p["mode"] == "always"):
        raise NotImplementedError(
            "training-mode Dropout is not ported yet (ROADMAP.md, queue "
            "item 3: training)")
    return x


@register("softmax", input_names=("data",),
          args=[Arg("axis", int, -1), Arg("temperature", float, None)])
def _softmax(p, x):
    t = p["temperature"] or 1.0
    return torch.softmax(x / t, dim=p["axis"])


@register("log_softmax", input_names=("data",),
          args=[Arg("axis", int, -1), Arg("temperature", float, None)])
def _log_softmax(p, x):
    t = p["temperature"] or 1.0
    return torch.log_softmax(x / t, dim=p["axis"])
