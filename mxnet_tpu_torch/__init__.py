"""mxnet_tpu_torch: the PyTorch/CUDA port of the mxnet_tpu package.

A second package beside the JAX reference, with the same module layout and
names: ``mx.nd`` (functions on ``torch.Tensor`` generated from the op
registry), ``mx.gluon`` (Blocks that are ``torch.nn.Module``s), ``mx.init``,
``mx.random`` and contexts.  ``mx.gpu(i)`` is CUDA device i and the default
context; ``mx.cpu()`` runs only when the caller asks for it.  The kernels
that the JAX package wrote in Pallas are hand-written CUDA for Hopper
(``kernels/``, ``csrc/``), built with nvcc on first use.

``mx.sym`` builds Symbol graphs (a hybridized block traces itself into
one); ``mx.predictor`` and ``mx.serving`` serve such a graph: the
flash-attention TransformerLM behind shape buckets, a micro-batcher and an
admission-controlled server.  ``mx.autograd``, ``mx.optimizer``,
``mx.lr_scheduler``, ``gluon.loss`` and ``gluon.Trainer`` train it, with
the flash kernel's hand-written backward; ``gluon.model_zoo.vision``,
``gluon.data`` and ``mx.metric`` train and score the vision families
(ResNet, VGG, AlexNet, SqueezeNet, DenseNet, Inception, MobileNet) on
PyTorch's cuDNN convolutions.  The symbolic path trains a Symbol:
``Symbol.simple_bind``/``bind`` give an ``mx.executor.Executor``,
``mx.mod.Module`` fits it from ``mx.io`` iterators through ``mx.kv``
(``mx.kvstore``), with ``mx.model`` checkpoints, ``mx.callback`` and
``mx.monitor``.  ``mx.recordio``, ``mx.image`` and ``mx.io``'s record
iterators read ``.rec`` files, the raw-tensor ones through the native
host runtime (``_native``, built from ``src/runtime`` with g++ on first
use).  ``mx.checkpoint`` writes atomic, validated checkpoint
directories (async, with retention) that resume a Trainer or a
``Module.fit`` and hot-reload a served predictor.  ``gluon.rnn``,
``mx.rnn``, ``mx.mod.BucketingModule``, the sequence ops and the CTC loss
train and serve recurrent models.  ``mx.operator`` (the ``Custom`` op),
``mx.contrib`` and the detection and vision ops (``Proposal``,
``ROIPooling``, ``MultiBox*``; greedy NMS and ROI pooling as hand-written
kernels) complete the op registry.  It imports torch and numpy (and
scipy's LAPACK inside ``_linalg_syevd``), never jax or the JAX package.
"""

__version__ = "1.0.0.torch0"

from . import base
from .base import MXNetError
from . import context
from .context import Context, current_context, cpu, gpu
from . import autograd
from . import ops  # registers all operators
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import attribute
from .attribute import AttrScope
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import random
from . import name
from .name import NameManager
from . import initializer
from .initializer import init
from . import kernels
from . import lr_scheduler
from . import optimizer
from .optimizer import Optimizer
from . import metric
from . import gluon
from . import convert
from . import observability
from . import predictor
from . import serving
from . import executor
from . import kvstore
from . import kvstore as kv
from .kvstore import KVStore
from . import io
from . import recordio
from . import image
from . import model
from . import module
from . import module as mod
from . import rnn
from . import operator
from . import contrib
nd.contrib = contrib.ndarray
sym.contrib = contrib.symbol
from . import callback
from . import monitor
from . import monitor as mon
from .monitor import Monitor
from . import checkpoint
from . import autotune
from . import analysis
from . import faultinject
from . import resilience
from . import profiler
