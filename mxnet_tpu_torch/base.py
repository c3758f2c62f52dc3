"""Core shared definitions: errors, dtype tables, registries, small utils.

The PyTorch counterpart of ``mxnet_tpu/base.py``: ``MXNetError``,
``getenv``, ``Registry`` and the declarative ``Arg``/``ParamSchema`` op
parameter schema are the same code.  The dtype table maps MXNet/numpy
dtype names onto ``torch.dtype``s; bfloat16 is first-class.
"""
from __future__ import annotations

import ast
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as _np
import torch


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: mxnet.base.MXNetError)."""


# ---------------------------------------------------------------------------
# dtype tables: numpy (host) <-> torch (device).  bfloat16 on the host is
# ml_dtypes.bfloat16, as in the JAX package.
# ---------------------------------------------------------------------------
try:
    import ml_dtypes as _mld
    bfloat16 = _np.dtype(_mld.bfloat16)
except ImportError:  # pragma: no cover
    bfloat16 = None

_NP_TO_TORCH = {
    _np.dtype(_np.float32): torch.float32,
    _np.dtype(_np.float64): torch.float64,
    _np.dtype(_np.float16): torch.float16,
    _np.dtype(_np.uint8): torch.uint8,
    _np.dtype(_np.int8): torch.int8,
    _np.dtype(_np.int32): torch.int32,
    _np.dtype(_np.int64): torch.int64,
    _np.dtype(_np.bool_): torch.bool,
}
if bfloat16 is not None:
    _NP_TO_TORCH[bfloat16] = torch.bfloat16
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def np_dtype(dtype) -> _np.dtype:
    """Canonicalize a user-supplied dtype (str/np.dtype/type/torch.dtype)."""
    if dtype is None:
        return _np.dtype(_np.float32)
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    if isinstance(dtype, str) and dtype == "bfloat16":
        if bfloat16 is None:
            raise MXNetError("bfloat16 requires ml_dtypes")
        return bfloat16
    return _np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of an MXNet dtype name, numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    nd = np_dtype(dtype)
    if nd not in _NP_TO_TORCH:
        raise MXNetError(f"dtype {nd} has no torch counterpart")
    return _NP_TO_TORCH[nd]


def getenv(name: str, default):
    """Typed env lookup (parity: dmlc::GetEnv). MXNET_* envs keep their names."""
    val = os.environ.get(name)
    if val is None:
        return default
    ty = type(default)
    if ty is bool:
        return val not in ("0", "false", "False", "")
    return ty(val)


# ---------------------------------------------------------------------------
# Generic registry (parity: dmlc::Registry / python/mxnet/registry.py)
# ---------------------------------------------------------------------------
class Registry:
    """Name → object registry with alias support."""

    def __init__(self, kind: str):
        self.kind = kind
        self._map: Dict[str, Any] = {}

    def register(self, obj=None, name: Optional[str] = None):
        def _do(o):
            key = (name or getattr(o, "__name__", None) or o.name).lower()
            self._map[key] = o
            return o
        return _do(obj) if obj is not None else _do

    def get(self, name: str):
        key = name.lower()
        if key not in self._map:
            raise MXNetError(
                f"{self.kind} '{name}' is not registered; known: {sorted(self._map)}")
        return self._map[key]

    def find(self, name: str):
        return self._map.get(name.lower())

    def create(self, name_or_obj, *args, **kwargs):
        if isinstance(name_or_obj, str):
            return self.get(name_or_obj)(*args, **kwargs)
        return name_or_obj

    def list(self) -> List[str]:
        return sorted(self._map)


# ---------------------------------------------------------------------------
# Declarative op/iterator parameter schema (parity: dmlc::Parameter<T>)
# ---------------------------------------------------------------------------
@dataclass
class Arg:
    name: str
    type: Callable = float
    default: Any = None
    required: bool = False
    doc: str = ""


class ParamSchema:
    """Validates/normalizes kwargs for an op into a canonical hashable tuple.

    `open_schema=True` passes unknown kwargs through as strings.
    """

    def __init__(self, args: List[Arg], open_schema: bool = False):
        self.args = {a.name: a for a in args}
        self.open_schema = open_schema

    @staticmethod
    def _canon(ty, v):
        if v is None:
            return None
        if ty in (tuple, "shape"):
            if isinstance(v, str):
                # "(2, 2)" from string configs and graph files: a literal
                # only, never code
                v = ast.literal_eval(v)
            if isinstance(v, (int, _np.integer)):
                return (int(v),)
            # None entries stay None (open-ended slice bounds)
            return tuple(None if x is None else int(x) for x in v)
        if ty == "floats":  # float tuple
            if isinstance(v, str):
                v = ast.literal_eval(v)
            if isinstance(v, (int, float, _np.integer, _np.floating)):
                return (float(v),)
            return tuple(float(x) for x in v)
        if ty is bool:
            if isinstance(v, str):
                return v.lower() in ("1", "true", "yes")
            return bool(v)
        if ty is int:
            return int(v)
        if ty is float:
            return float(v)
        if ty is str:
            return str(v)
        return ty(v)

    def normalize(self, kwargs: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
        out = {}
        for k, v in kwargs.items():
            if k not in self.args:
                if self.open_schema:
                    out[k] = str(v)
                    continue
                raise MXNetError(f"unknown argument '{k}'; expected {sorted(self.args)}")
            out[k] = self._canon(self.args[k].type, v)
        for a in self.args.values():
            if a.name not in out:
                if a.required:
                    raise MXNetError(f"required argument '{a.name}' missing")
                out[a.name] = self._canon(a.type, a.default) if a.default is not None else a.default
        return tuple(sorted(out.items()))


class _ThreadLocalStack(threading.local):
    """Per-thread stack used by with-scopes (Context, NameManager)."""

    def __init__(self):
        self.stack: List[Any] = []

    def top(self):
        return self.stack[-1] if self.stack else None

    def push(self, v):
        self.stack.append(v)

    def pop(self):
        return self.stack.pop()
