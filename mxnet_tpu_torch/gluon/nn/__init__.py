"""gluon.nn: the layers of the serving slice."""
from .basic_layers import (Activation, Dense, Dropout, Embedding,
                           HybridSequential, LayerNorm)
