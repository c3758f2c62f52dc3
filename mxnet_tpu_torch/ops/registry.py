"""Operator registry: one definition per op, called eagerly on tensors.

The counterpart of ``mxnet_tpu/ops/registry.py``: the same ``Operator``
record and ``register`` decorator with the same ``Arg`` schemas, so an op
takes the same keyword arguments in both packages.  Each op is one function
``fn(params, *inputs)`` on ``torch.Tensor``s; ``apply_op`` calls it directly
(PyTorch runs eagerly, so there is no per-op compile cache).  The ``nd``
namespace is generated from this table (``ndarray/register.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

from ..base import Arg, MXNetError, ParamSchema

# name -> Operator
OP_REGISTRY: Dict[str, "Operator"] = {}
# alias -> canonical name
OP_ALIASES: Dict[str, str] = {}


@dataclass
class Operator:
    """One operator definition.

    fn(params: dict, *inputs) -> tensor | tuple of tensors
      - params: normalized kwargs (plus '__is_train__' if takes_is_train)
      - inputs: torch tensors
    """

    name: str
    fn: Callable
    input_names: List[str]
    schema: ParamSchema
    num_outputs: int = 1
    # input positions that are auxiliary states (BatchNorm's moving
    # statistics): fn returns one extra trailing output per aux input, its
    # updated value, which the caller writes back into the aux tensor
    aux_inputs: List[int] = field(default_factory=list)
    variadic: bool = False          # takes *args (Concat)
    takes_is_train: bool = False    # receives '__is_train__' in params
    differentiable: bool = True
    # input positions that stay float32 under reduced-precision casts
    # (token ids and positions: bf16's 8-bit mantissa corrupts ids > 256)
    f32_inputs: Tuple[int, ...] = ()
    docstring: str = ""

    def normalize(self, kwargs) -> Tuple[Tuple[str, object], ...]:
        return self.schema.normalize(kwargs)


def register(name, input_names=("data",), args: Sequence[Arg] = (),
             num_outputs: int = 1, aliases: Sequence[str] = (), **flags):
    """Decorator registering a torch forward as a framework operator."""

    def _reg(fn):
        op = Operator(
            name=name,
            fn=fn,
            input_names=list(input_names),
            schema=ParamSchema(list(args)),
            num_outputs=num_outputs,
            docstring=fn.__doc__ or "",
            **flags,
        )
        if name in OP_REGISTRY:
            raise MXNetError(f"op '{name}' registered twice")
        OP_REGISTRY[name] = op
        for a in aliases:
            OP_ALIASES[a] = name
        return fn

    return _reg


def get_op(name: str) -> Operator:
    cname = OP_ALIASES.get(name, name)
    if cname not in OP_REGISTRY:
        raise MXNetError(f"operator '{name}' not registered")
    return OP_REGISTRY[cname]


def list_ops() -> List[str]:
    return sorted(OP_REGISTRY) + sorted(OP_ALIASES)


def apply_op(op: Operator, params: Dict[str, object], inputs) -> Tuple:
    """Run the op eagerly on tensors; returns a tuple of all its outputs,
    the updated aux values last."""
    out = op.fn(params, *inputs)
    return out if isinstance(out, tuple) else (out,)
