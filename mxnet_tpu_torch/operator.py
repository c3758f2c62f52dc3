"""mx.operator: user-defined operators in Python (parity:
``mxnet_tpu/operator.py``, upstream ``python/mxnet/operator.py:418-598``).

``CustomOpProp`` subclasses registered with ``register(name)`` feed the
``Custom`` operator (``ops/custom.py``): ``mx.nd.Custom(x, op_type=name)``,
``mx.sym.Custom(...)`` in a graph bound by ``Module``, and autograd.  The
op's ``forward``/``backward`` get the port's tensors on the op's device.
"""
from __future__ import annotations

from .base import MXNetError
from .ops.custom import CUSTOM_PROP_REGISTRY


class CustomOp:
    """Base class for operators implemented in Python."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute out_data from in_data; use self.assign(dst, req, src)."""

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute in_grad; use self.assign(dst, req, src)."""

    def assign(self, dst, req, src):
        """Write src into dst as the request says: nothing for "null", a
        copy for "write"/"inplace", a sum for "add"."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] += src


class CustomOpProp:
    """Base class of a custom operator's properties: its arguments,
    outputs, shape and type inference, and the ``CustomOp`` it creates."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, (in_shape[0],) * len(self.list_outputs()), ()

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a ``CustomOpProp`` subclass under ``op_type=reg_name``."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("can only register subclasses of CustomOpProp")
        CUSTOM_PROP_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_all_registered_operators():
    return list(CUSTOM_PROP_REGISTRY)


class PythonOp:
    """The deprecated v0.x base, superseded by CustomOp/CustomOpProp."""

    def __init__(self, *a, **kw):
        raise MXNetError("PythonOp is deprecated; use "
                         "mx.operator.CustomOp + CustomOpProp + register")


class NativeOp(PythonOp):
    pass


class NDArrayOp(PythonOp):
    pass


class NumpyOp(PythonOp):
    """The deprecated v0.x numpy op base, superseded by
    CustomOp/CustomOpProp."""
