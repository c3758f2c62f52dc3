"""gluon: the imperative/hybrid layer API (parity: python/mxnet/gluon)."""
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .block import Block, CachedOp, HybridBlock, SymbolBlock
from . import nn
from . import loss
from . import rnn
from . import data
from . import utils
from . import model_zoo
from .trainer import Trainer
from . import wholestep
from .wholestep import WholeStepCompiler
from . import supervisor
from .supervisor import TrainingSupervisor
