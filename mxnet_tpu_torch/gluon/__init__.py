"""gluon: the imperative/hybrid layer API (parity: python/mxnet/gluon)."""
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .block import Block, CachedOp, HybridBlock, SymbolBlock
from . import nn
from . import model_zoo
