"""Standalone inference predictor (parity: the C predict API,
``include/mxnet/c_predict_api.h:78-179`` MXPredCreate / SetInput / Forward
/ GetOutput / Reshape, and ``mxnet_tpu/predictor.py``).

It loads a serialized Symbol and its parameters and runs forward only, at
the input shapes it was created with.  The graph runs through
``GraphPlan`` on the predictor's device, ``gpu(0)`` (the current context)
unless ``dev=mx.cpu()`` is passed; without a CUDA device and without
``mx.cpu()`` it raises ``MXNetError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as _np
import torch

from .base import MXNetError
from .context import as_device, current_context
from . import ndarray as nd
from . import symbol as sym_mod
from .symbol.graph import GraphPlan


def load_param_payload(params, ctx=None) -> Dict[str, torch.Tensor]:
    """Normalize a param payload to {name: tensor on ``ctx``} (default:
    the current context).

    Accepts a ready dict (tensor or numpy values), a serialized blob as
    bytes (parsed in memory, as MXPredCreate takes the blob by pointer) or
    a file path."""
    if isinstance(params, dict):
        return {k: nd.array(v, ctx=ctx) for k, v in params.items()}
    if isinstance(params, (bytes, bytearray, memoryview)):
        loaded = nd.load_frombuffer(bytes(params), ctx=ctx)
    else:
        loaded = nd.load(params, ctx=ctx)
    if not isinstance(loaded, dict):
        raise MXNetError(
            "param payload must carry named arrays (arg:/aux: prefixes "
            "or plain names); got an unnamed list")
    return loaded


def split_arg_aux(params: Dict[str, torch.Tensor]):
    """Split a loaded param dict on the ``arg:``/``aux:`` save prefixes
    (unprefixed names count as args, matching MXPredCreate)."""
    arg_params, aux_params = {}, {}
    for k, v in params.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


class Predictor:
    """Parity: MXPredCreate -> the handle; methods mirror the C calls."""

    def __init__(self, symbol_json: str, param_bytes_or_file,
                 input_shapes: Dict[str, tuple], dev=None,
                 output_names: Optional[Sequence[str]] = None):
        symbol = sym_mod.load_json(symbol_json)
        if output_names:
            internals = symbol.get_internals()
            symbol = sym_mod.Group([internals[n] for n in output_names])
        self._symbol = symbol
        self._ctx = dev if dev is not None else current_context()
        as_device(self._ctx)  # a gpu context without CUDA raises here
        arg_params, self._aux = split_arg_aux(
            load_param_payload(param_bytes_or_file, ctx=self._ctx))
        arg_names = symbol.list_arguments()
        self._input_names = [n for n in arg_names if n not in arg_params]
        self._args = dict(arg_params)
        for name, shp in input_shapes.items():
            self._args[name] = nd.zeros(shp, ctx=self._ctx)
        missing = [n for n in self._input_names if n not in input_shapes]
        if missing:
            # label inputs of training symbols get inferred zero
            # placeholders (c_predict_api binds only the data inputs)
            arg_shapes, _, _ = symbol.infer_shape_partial(**input_shapes)
            inferred = dict(zip(arg_names, arg_shapes or []))
            for name in missing:
                shp = inferred.get(name)
                if shp is None:
                    raise MXNetError(
                        f"input '{name}' requires a shape (MXPredCreate "
                        f"input_shapes parity)")
                self._args[name] = nd.zeros(shp, ctx=self._ctx)
        self._plan = GraphPlan(symbol)
        self._outputs: List[torch.Tensor] = []

    # -- C-api-shaped methods ------------------------------------------------
    def set_input(self, name: str, data) -> None:
        """MXPredSetInput: copy ``data`` (numpy or tensor) into the input,
        in the input's dtype; any layout with the same element count."""
        if name not in self._input_names:
            raise MXNetError(f"unknown input '{name}'; inputs: "
                             f"{self._input_names}")
        arr = data if isinstance(data, torch.Tensor) \
            else nd.array(data, ctx=self._ctx)
        tgt = self._args[name]
        if tuple(arr.shape) != tuple(tgt.shape):
            if arr.numel() != tgt.numel():
                raise MXNetError(
                    f"set_input('{name}'): got {arr.numel()} elements, "
                    f"expected {tgt.numel()} {tuple(tgt.shape)}")
            arr = arr.reshape(tgt.shape)
        tgt.copy_(arr)

    def forward(self) -> None:
        """MXPredForward."""
        with torch.no_grad():
            self._outputs, _ = self._plan.run(self._args, self._aux)

    def get_output(self, index: int = 0) -> _np.ndarray:
        """MXPredGetOutput: a host numpy copy."""
        if not self._outputs:
            raise MXNetError("call forward() before get_output()")
        return nd.asnumpy(self._outputs[index])

    @property
    def outputs(self) -> List[torch.Tensor]:
        """The last forward's outputs, on the predictor's device (what a
        decode loop feeds back through ``set_input``)."""
        if not self._outputs:
            raise MXNetError("call forward() before outputs")
        return list(self._outputs)

    @property
    def num_outputs(self) -> int:
        return len(self._symbol.list_outputs())

    def reshape(self, new_input_shapes: Dict[str, tuple]) -> "Predictor":
        """MXPredReshape: new input shapes, parameters shared."""
        for name, shp in new_input_shapes.items():
            self._args[name] = nd.zeros(shp, ctx=self._ctx,
                                        dtype=self._args[name].dtype)
        self._outputs = []
        return self


def create(symbol_file: str, param_file: str,
           input_shapes: Dict[str, tuple], dev=None) -> Predictor:
    """Parity: MXPredCreate from files (prefix-symbol.json + prefix.params)."""
    with open(symbol_file) as f:
        symbol_json = f.read()
    return Predictor(symbol_json, param_file, input_shapes, dev)
