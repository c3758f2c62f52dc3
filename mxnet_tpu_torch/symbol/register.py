"""Symbol op functions: ``sym.<op>(...)`` generated from the op registry.

The counterpart of ``mxnet_tpu/symbol/register.py``: one function per
registered op and per alias, as the ``nd`` namespace has
(``ndarray/register.py``).  Positional Symbols are the op's inputs,
positional values after them fill the schema's arguments in declared
order, keyword Symbols are inputs by name.  A declared input that is not
given becomes a new variable named ``<node>_<input>`` (``fc1_weight``),
as in the reference's symbol composition.
"""
from __future__ import annotations

from ..attribute import current_attrs
from ..base import np_dtype
from ..name import NameManager
from ..ops import registry as _reg
from .symbol import Symbol, Variable, _Node, _truthy


def _auto_input_names(op, params):
    """Which declared inputs this node needs, given params."""
    names = list(op.input_names)
    if op.name == "FullyConnected":
        no_bias = dict(params).get("no_bias")
        if no_bias is None:
            no_bias = op.schema.args["no_bias"].default
        if _truthy(no_bias):
            names.remove("bias")
    return names


def invoke_symbol(op_name: str, sym_inputs, kwargs, name=None,
                  attr=None) -> Symbol:
    op = _reg.get_op(op_name)
    kwargs = dict(kwargs)
    kwargs.pop("ctx", None)
    name = name or kwargs.pop("name", None)
    attr = attr or kwargs.pop("attr", None)
    kwargs.pop("num_args", None)

    # split kwargs into symbol inputs vs op params
    named_inputs = {}
    params = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            named_inputs[k] = v
        elif v is not None:
            if k == "dtype" and not isinstance(v, str):
                v = np_dtype(v).name
            params[k] = v

    hint = op_name.lower().lstrip("_")
    node_name = NameManager.current().get(name, hint)
    attrs = current_attrs(attr)

    if op.variadic:
        inputs = [s._entries[0] for s in sym_inputs]
        if "num_args" in op.schema.args:
            params["num_args"] = len(inputs)
    else:
        needed = _auto_input_names(op, params)
        pos = list(sym_inputs)
        entries = {}
        for nm in needed:
            if nm in named_inputs:
                entries[nm] = named_inputs[nm]._entries[0]
            elif pos:
                entries[nm] = pos.pop(0)._entries[0]
            else:
                entries[nm] = Variable(f"{node_name}_{nm}")._entries[0]
        inputs = [entries[nm] for nm in needed]

    node = _Node(op_name, node_name, params=params, inputs=inputs,
                 attrs=attrs)
    n_out = node.num_outputs()
    return Symbol([(node, i) for i in range(n_out)])


def _make_sym_func(op_name: str):
    op = _reg.get_op(op_name)

    def fn(*args, **kwargs):
        sym_inputs = []
        rest = list(args)
        while rest and isinstance(rest[0], Symbol):
            sym_inputs.append(rest.pop(0))
        taken = [n for n in op.schema.args if n not in kwargs]
        for v, n in zip(rest, taken):
            kwargs[n] = v
        return invoke_symbol(op_name, sym_inputs, kwargs)

    fn.__name__ = op_name
    fn.__qualname__ = op_name
    fn.__doc__ = op.docstring or f"Symbolic wrapper for operator '{op_name}'."
    return fn


def populate(namespace: dict) -> None:
    """Generate one function per op and per alias into ``namespace``."""
    for name in list(_reg.OP_REGISTRY) + list(_reg.OP_ALIASES):
        namespace[name] = _make_sym_func(name)
