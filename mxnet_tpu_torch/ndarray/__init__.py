"""`mx.nd` namespace: tensor constructors plus one function per registered
operator (parity: python/mxnet/ndarray/__init__.py)."""
from .. import ops  # registers all operators
from .ndarray import (array, asnumpy, attach_grad, grad, load,
                      load_frombuffer, save, zeros)
from .register import invoke, populate

populate(globals())
