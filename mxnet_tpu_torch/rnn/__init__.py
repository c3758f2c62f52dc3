"""mx.rnn (parity: ``mxnet_tpu/rnn/__init__.py``): the symbol-level cells,
``BucketSentenceIter`` and the rnn checkpoint helpers."""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell, FusedRNNCell,
                       SequentialRNNCell, BidirectionalCell, DropoutCell,
                       ZoneoutCell, ResidualCell, ModifierCell, RNNParams,
                       BaseConvRNNCell, ConvRNNCell, ConvLSTMCell,
                       ConvGRUCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint,
                  rnn_unroll)
