"""mx.contrib.symbol: contrib op functions composing Symbols."""
from .. import symbol as _sym

ctc_loss = _sym.ctc_loss
CTCLoss = _sym.CTCLoss
fft = _sym.fft
ifft = _sym.ifft
quantize = _sym._contrib_quantize
dequantize = _sym._contrib_dequantize
count_sketch = _sym._contrib_count_sketch
MultiBoxPrior = _sym.MultiBoxPrior
MultiBoxTarget = _sym.MultiBoxTarget
MultiBoxDetection = _sym.MultiBoxDetection
