"""mx.contrib.symbol: contrib op functions composing Symbols."""
from .. import symbol as _sym

ctc_loss = _sym.ctc_loss
CTCLoss = _sym.CTCLoss
