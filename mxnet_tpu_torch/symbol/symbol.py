"""Symbol: the declarative graph IR (parity: nnvm Symbol + python/mxnet/symbol).

The counterpart of ``mxnet_tpu/symbol/symbol.py``: the same ``_Node`` DAG,
composition, arithmetic, ``Group``/``Variable`` and the same graph JSON
(nnvm-style ``nodes`` / ``arg_nodes`` / ``heads``), so a graph file written
by either package loads in the other.  ``GraphPlan`` (``graph.py``) runs a
Symbol eagerly on tensors; ``simple_bind``, ``bind`` and ``eval`` bind it to
an ``Executor`` (``executor.py``), which trains it.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..attribute import current_attrs
from ..base import MXNetError, np_dtype
from ..ops import registry as _reg
from ..ops.custom import custom_num_outputs

class _Node:
    __slots__ = ("op", "name", "params", "inputs", "attrs")

    def __init__(self, op: Optional[str], name: str, params=None, inputs=None,
                 attrs=None):
        self.op = op              # None for variables
        self.name = name
        self.params = dict(params or {})
        self.inputs: List[Tuple["_Node", int]] = list(inputs or [])
        self.attrs = dict(attrs or {})

    @property
    def is_var(self) -> bool:
        return self.op is None

    def num_outputs(self) -> int:
        if self.is_var:
            return 1
        op = _reg.get_op(self.op)
        if op.name == "SliceChannel":
            return int(dict(self.params).get("num_outputs", 1))
        if op.name == "Custom":
            return custom_num_outputs(dict(self.params))
        if op.name == "RNN":
            return 3 if _truthy(self.params.get("state_outputs")) else 1
        if op.name in ("BatchNorm", "LayerNorm"):
            return 1  # mean/var exposed only via output_mean_var
        return max(op.num_outputs, 1)


def _truthy(v):
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    return bool(v)


class Symbol:
    """An immutable handle to one or more output entries of the graph."""

    def __init__(self, entries: List[Tuple[_Node, int]]):
        self._entries = entries

    # -- composition --------------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def __getitem__(self, index):
        if isinstance(index, str):
            outputs = self.list_outputs()
            if index not in outputs:
                raise MXNetError(f"no output named {index}; have {outputs}")
            index = outputs.index(index)
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        for i in range(len(self._entries)):
            yield self[i]

    def get_internals(self) -> "Symbol":
        """All intermediate outputs (parity: symbol.get_internals)."""
        entries = []
        for node in self._topo():
            for i in range(node.num_outputs()):
                entries.append((node, i))
        return Symbol(entries)

    def get_children(self) -> Optional["Symbol"]:
        """The inputs of this symbol's first output's node (None for a
        variable)."""
        node = self._entries[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def debug_str(self) -> str:
        """One line per node in topological order: its op (or
        ``Variable``), name and input entries."""
        lines = []
        for n in self._topo():
            kind = "Variable" if n.is_var else n.op
            ins = ", ".join(f"{s.name}[{i}]" for s, i in n.inputs)
            lines.append(f"{kind} {n.name}({ins})")
        return "\n".join(lines)

    # -- graph traversal ----------------------------------------------------
    def _topo(self) -> List[_Node]:
        seen = set()
        order: List[_Node] = []

        def visit(node: _Node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for src, _ in node.inputs:
                visit(src)
            order.append(node)

        for node, _ in self._entries:
            visit(node)
        return order

    def _aux_var_ids(self) -> set:
        """The variables that feed an op's ``aux_inputs`` (BatchNorm's
        moving statistics)."""
        aux = set()
        for node in self._topo():
            if node.is_var:
                continue
            for ai in _reg.get_op(node.op).aux_inputs:
                if ai < len(node.inputs) and node.inputs[ai][0].is_var:
                    aux.add(id(node.inputs[ai][0]))
        return aux

    def list_arguments(self) -> List[str]:
        aux = self._aux_var_ids()
        return [n.name for n in self._topo() if n.is_var and id(n) not in aux]

    def list_auxiliary_states(self) -> List[str]:
        aux = self._aux_var_ids()
        return [n.name for n in self._topo() if n.is_var and id(n) in aux]

    def list_inputs(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_var]

    def list_outputs(self) -> List[str]:
        outs = []
        for node, idx in self._entries:
            if node.is_var:
                outs.append(node.name)
            elif node.num_outputs() == 1:
                outs.append(node.name + "_output")
            else:
                outs.append(f"{node.name}_output{idx}")
        return outs

    def list_attr(self) -> Dict[str, str]:
        return dict(self._entries[0][0].attrs)

    def attr(self, key: str) -> Optional[str]:
        return self._entries[0][0].attrs.get(key)

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        """{node name: its attributes and, for an op, its parameters as
        strings} over the whole graph (parity: symbol.attr_dict)."""
        out = {}
        for node in self._topo():
            d = dict(node.attrs)
            if node.op is not None:
                d.update({k: str(v) for k, v in node.params.items()
                          if v is not None})
            if d:
                out[node.name] = d
        return out

    # -- call composition: net(data=other_sym) -------------------------------
    def __call__(self, *args, **kwargs) -> "Symbol":
        out = self.__copy__()
        out._compose(*args, **kwargs)
        return out

    def _compose(self, *args, **kwargs):
        name_map = {}
        if args:
            free = [n for n in self._topo() if n.is_var]
            for var, rep in zip(free, args):
                name_map[var.name] = rep
        name_map.update(kwargs)
        table = {}
        for node in self._topo():
            if node.is_var and node.name in name_map:
                table[id(node)] = name_map[node.name]._entries[0]
        if not table:
            return
        self._entries = [_substitute(e, table, {}) for e in self._entries]

    def __copy__(self):
        return Symbol(list(self._entries))

    # -- arithmetic -----------------------------------------------------------
    def _binary(self, other, op, scalar_op, rop=False):
        from . import register as _r
        if isinstance(other, Symbol):
            a, b = (other, self) if rop else (self, other)
            return _r.invoke_symbol(op, [a, b], {})
        return _r.invoke_symbol(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_rminus_scalar", rop=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_rdiv_scalar", rop=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return self._binary(-1.0, None, "_mul_scalar")

    def __hash__(self):
        return id(self)

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binary(o, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    # -- inference ------------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        from .graph import infer_shape
        return infer_shape(self, False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        from .graph import infer_shape
        return infer_shape(self, True, *args, **kwargs)

    def infer_type(self, *args, **kwargs):
        from .graph import infer_type
        return infer_type(self, *args, **kwargs)

    # -- binding --------------------------------------------------------------
    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Allocate zeroed arguments, gradients and aux states from the
        inferred shapes and types on ``ctx``, and bind (parity:
        symbol.py:1255, MXExecutorSimpleBind).  ``kwargs`` are input
        shapes, ``type_dict`` input dtypes; an argument found in
        ``shared_buffer`` with its shape is shared.  ``shared_exec`` and
        ``shared_arg_names`` are accepted and unused: an eager executor has
        no compiled program to share."""
        from ..context import as_device
        from ..executor import Executor
        from ..ndarray import zeros
        if stype_dict and any(v != "default" for v in stype_dict.values()):
            raise NotImplementedError(
                "simple_bind(stype_dict=...): sparse storage is not ported "
                "yet (ROADMAP.md, queue item 6: scale-out and sparse)")
        device = as_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_types, _, aux_types = self.infer_type(**(type_dict or {}))
        args = {}
        for name, shp, dt in zip(self.list_arguments(), arg_shapes,
                                 arg_types):
            if shared_buffer is not None and name in shared_buffer and \
                    tuple(shared_buffer[name].shape) == tuple(shp):
                args[name] = shared_buffer[name]
            else:
                args[name] = zeros(shp, ctx=device, dtype=dt)
                if shared_buffer is not None:
                    shared_buffer[name] = args[name]
        aux = {name: zeros(shp, ctx=device, dtype=dt) for name, shp, dt in
               zip(self.list_auxiliary_states(), aux_shapes, aux_types)}
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in args}
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(self.list_arguments(), grad_req))
        else:
            reqs = dict(grad_req)
        grads = {n: zeros(args[n].shape, ctx=device, dtype=args[n].dtype)
                 for n in args if reqs.get(n, "null") != "null"}
        return Executor(self, ctx, args, grads, reqs, aux,
                        group2ctx=group2ctx)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind to the caller's tensors (parity: symbol.py:1519): ``args``
        and ``args_grad`` are lists in ``list_arguments()`` order or dicts;
        an argument takes a gradient only when it has a buffer in
        ``args_grad``.  ``shared_exec`` is accepted and unused."""
        from ..executor import Executor
        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        args_grad = args_grad or {}
        if isinstance(grad_req, str):
            reqs = {n: (grad_req if n in args_grad else "null")
                    for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(arg_names, grad_req))
        else:
            reqs = {n: grad_req.get(n, "null") for n in arg_names}
        aux = aux_states or {}
        if isinstance(aux, (list, tuple)):
            aux = dict(zip(self.list_auxiliary_states(), aux))
        return Executor(self, ctx, args, args_grad, reqs, aux,
                        group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` as the arguments on ``ctx`` (default: the
        current context) and run one forward; returns the outputs."""
        from ..context import current_context
        return self.bind(ctx or current_context(), kwargs).forward()

    # -- serialization ---------------------------------------------------------
    def tojson(self) -> str:
        """MXNet graph-JSON compatible serialization (parity: nnvm JSON)."""
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_var else n.op,
                "name": n.name,
                "attrs": {k: str(v) for k, v in n.params.items()
                          if v is not None} if n.params else {},
                "inputs": [[nid[id(s)], i, 0] for s, i in n.inputs],
            })
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_var]
        heads = [[nid[id(n)], i, 0] for n, i in self._entries]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10000]}},
                          indent=2)

    def save(self, fname: str) -> None:
        """Write ``tojson()`` beside ``fname`` and move it over ``fname``
        with one ``os.replace``: a crash never leaves a torn file."""
        tmp = f"{fname}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.tojson())
        os.replace(tmp, fname)


def _substitute(entry, table, memo):
    """``entry`` with the variables in ``table`` replaced; nodes that reach
    no replaced variable are shared, the others copied once (``memo``)."""
    node, idx = entry
    if id(node) in table:
        return (table[id(node)][0],
                idx if not node.is_var else table[id(node)][1])
    if id(node) in memo:
        return (memo[id(node)], idx)
    if node.is_var:
        return entry
    new_inputs = [_substitute(e, table, memo) for e in node.inputs]
    if all(a is b for a, b in zip(new_inputs, node.inputs)):
        return entry
    nn = _Node(node.op, node.name, node.params, new_inputs, node.attrs)
    memo[id(node)] = nn
    return (nn, idx)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs) -> Symbol:
    """Parity: symbol.var — free variable node with optional attr hints."""
    attrs = current_attrs(attr)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(np_dtype(dtype).name)
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    node = _Node(None, name, attrs=attrs)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str: str) -> Symbol:
    """Load MXNet graph JSON, as written by either package's ``tojson``
    (or by the reference for ops whose names and params match)."""
    g = json.loads(json_str)
    nodes: List[_Node] = []
    for jn in g["nodes"]:
        params = jn.get("attrs") or jn.get("param") or {}
        if jn["op"] == "null":
            node = _Node(None, jn["name"], attrs=params)
        else:
            inputs = [(nodes[i], oi) for i, oi, *_ in jn["inputs"]]
            node = _Node(jn["op"], jn["name"], params=params, inputs=inputs)
        nodes.append(node)
    heads = g.get("heads") or [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[h[0]], h[1]) for h in heads])


def zeros(shape, dtype=None, **kwargs) -> Symbol:
    from . import register as _r
    return _r.invoke_symbol("_zeros", [], {"shape": shape,
                                           "dtype": dtype or "float32"})


def ones(shape, dtype=None, **kwargs) -> Symbol:
    from . import register as _r
    return _r.invoke_symbol("_ones", [], {"shape": shape,
                                          "dtype": dtype or "float32"})


def arange(start, stop=None, step=1.0, repeat=1, dtype=None,
           **kwargs) -> Symbol:
    from . import register as _r
    return _r.invoke_symbol("_arange", [], {"start": start, "stop": stop,
                                            "step": step, "repeat": repeat,
                                            "dtype": dtype or "float32"})


def _binary_free_fn(op, scalar_op, rscalar_op, pyfn):
    """Scalar/Symbol-dispatching free function (parity: the symbol.py
    pow/maximum/minimum/hypot helpers, symbol/symbol.py:2524-2703)."""
    def fn(left, right):
        from . import register as _r
        lsym, rsym = isinstance(left, Symbol), isinstance(right, Symbol)
        if lsym and rsym:
            return _r.invoke_symbol(op, [left, right], {})
        if lsym:
            return _r.invoke_symbol(scalar_op, [left],
                                    {"scalar": float(right)})
        if rsym:
            return _r.invoke_symbol(rscalar_op, [right],
                                    {"scalar": float(left)})
        return pyfn(left, right)
    return fn


pow = _binary_free_fn("_power", "_power_scalar", "_rpower_scalar",
                      lambda a, b: a ** b)
maximum = _binary_free_fn("_maximum", "_maximum_scalar", "_maximum_scalar",
                          lambda a, b: a if a > b else b)
minimum = _binary_free_fn("_minimum", "_minimum_scalar", "_minimum_scalar",
                          lambda a, b: a if a < b else b)
hypot = _binary_free_fn("_hypot", "_hypot_scalar", "_hypot_scalar",
                        lambda a, b: (a * a + b * b) ** 0.5)
