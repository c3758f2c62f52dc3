"""mx.contrib (parity: ``mxnet_tpu/contrib/``): the contrib ops the port
has, over tensors (``contrib.ndarray``, also ``nd.contrib``) and Symbols
(``contrib.symbol``, also ``sym.contrib``).  Only the CTC loss so far; the
other contrib ops, ``autograd`` and ``tensorboard`` are ROADMAP.md item 7c."""
from . import ndarray
from . import symbol
