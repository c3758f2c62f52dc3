"""gluon.rnn (parity: ``mxnet_tpu/gluon/rnn/__init__.py``): recurrent cells
and the fused layers over the ``RNN`` op."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, DropoutCell, ModifierCell,
                       ResidualCell, ZoneoutCell, BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU
