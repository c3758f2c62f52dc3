"""mx.contrib.ndarray: contrib op functions over tensors."""
from .. import ndarray as _nd

ctc_loss = _nd.ctc_loss
CTCLoss = _nd.CTCLoss
fft = _nd.fft
ifft = _nd.ifft
quantize = _nd._contrib_quantize
dequantize = _nd._contrib_dequantize
count_sketch = _nd._contrib_count_sketch
MultiBoxPrior = _nd.MultiBoxPrior
MultiBoxTarget = _nd.MultiBoxTarget
MultiBoxDetection = _nd.MultiBoxDetection
