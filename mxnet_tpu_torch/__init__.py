"""mxnet_tpu_torch: the PyTorch/CUDA port of the mxnet_tpu package.

A second package beside the JAX reference, with the same module layout and
names: ``mx.nd`` (functions on ``torch.Tensor`` generated from the op
registry), ``mx.gluon`` (Blocks that are ``torch.nn.Module``s), ``mx.init``,
``mx.random`` and contexts.  ``mx.gpu(i)`` is CUDA device i and the default
context; ``mx.cpu()`` runs only when the caller asks for it.  The kernels
that the JAX package wrote in Pallas are hand-written CUDA for Hopper
(``kernels/``, ``csrc/``), built with nvcc on first use.

This slice serves the flash-attention TransformerLM: scoring and
static-shape decoding.  It imports torch and numpy, never jax or the JAX
package.
"""

__version__ = "1.0.0.torch0"

from . import base
from .base import MXNetError
from . import context
from .context import Context, current_context, cpu, gpu
from . import ops  # registers all operators
from . import ndarray
from . import ndarray as nd
from . import random
from . import name
from . import initializer
from .initializer import init
from . import kernels
from . import gluon
from . import convert
