"""mx.contrib.ndarray: contrib op functions over tensors."""
from .. import ndarray as _nd

ctc_loss = _nd.ctc_loss
CTCLoss = _nd.CTCLoss
