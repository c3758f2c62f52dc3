"""Carry parameters from an ``mxnet_tpu`` network into its port.

``params_from_mxnet_tpu`` takes the JAX package's parameters as plain numpy
arrays, ``{name: np.ndarray}`` (for example
``{n: p.data().asnumpy() for n, p in net.collect_params().items()}``), and
loads them into the port's network.  Names are matched relative to each
network's prefix, so ``transformerlm3_l0_attn_qkv_weight`` lands on the
port's ``transformerlm0_l0_attn_qkv_weight``.  Aux states (BatchNorm's
``running_mean`` and ``running_var``) are parameters in both packages and
move like the others.  A missing name, an extra name or a shape that
differs raises.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError


def _source_prefix(names) -> str:
    """The prefix every name shares up to its first '_' (the top block's
    ``<alias><count>_``), or '' when they share none."""
    heads = {n.split("_", 1)[0] + "_" for n in names if "_" in n}
    if len(heads) != 1:
        return ""
    head = heads.pop()
    return head if all(n.startswith(head) for n in names) else ""


def params_from_mxnet_tpu(np_params, net, prefix=None):
    """Load ``np_params`` ({name: numpy array} from an ``mxnet_tpu`` net's
    ``collect_params()``) into the port's ``net``.

    ``prefix`` is the source net's prefix (inferred when None).  The data
    lands on each parameter's own context (the one it was initialized or
    deferred with), else on the current context.
    """
    src_prefix = _source_prefix(list(np_params)) if prefix is None else prefix
    src = {}
    for name, value in np_params.items():
        if not name.startswith(src_prefix):
            raise MXNetError(f"source parameter {name!r} does not start with "
                             f"prefix {src_prefix!r}")
        src[name[len(src_prefix):]] = np.asarray(value)
    dst = {name[len(net.prefix):]: p
           for name, p in net.collect_params().items()}
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing from the source "
                         f"{missing}, not in the port's net {extra}")
    for rel, p in dst.items():
        value = src[rel]
        shape = p.shape or ()
        if len(shape) != value.ndim or any(
                d not in (0, v) for d, v in zip(shape, value.shape)):
            raise MXNetError(f"{p.name}: shape {p.shape} in the port's net, "
                             f"{value.shape} in the source")
        p._load_init(value, p._home_ctx())
    return net
