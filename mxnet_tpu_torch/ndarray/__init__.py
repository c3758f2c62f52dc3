"""`mx.nd` namespace: tensor constructors and free functions, one function
per registered operator, and the ``random`` and ``linalg`` namespaces
(parity: python/mxnet/ndarray/__init__.py)."""
import torch

from .. import ops  # registers all operators
from .register import invoke, populate

populate(globals())

from .ndarray import (add, arange, array, asnumpy, asscalar, attach_grad,
                      concatenate,
                      divide, empty, equal, eye, from_dlpack, from_numpy,
                      full, grad, greater, greater_equal, hypot, lesser,
                      lesser_equal, load, load_frombuffer, maximum, minimum,
                      modulo, moveaxis, multiply, not_equal, onehot_encode,
                      ones, pow, power, save, subtract, true_divide, waitall,
                      zeros)
from . import linalg, random

#: the port's arrays are ``torch.Tensor``s: ``isinstance(x, nd.NDArray)``
NDArray = torch.Tensor
