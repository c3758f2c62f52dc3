"""mx.contrib (parity: ``mxnet_tpu/contrib/``): the contrib ops over tensors
(``contrib.ndarray``, also ``nd.contrib``) and Symbols (``contrib.symbol``,
also ``sym.contrib``): CTC, fft/ifft, quantize/dequantize, count_sketch and
the SSD ops; the old ``autograd`` sections; the ``tensorboard`` metric
callback."""
from . import ndarray
from . import symbol
from . import autograd
from . import tensorboard
