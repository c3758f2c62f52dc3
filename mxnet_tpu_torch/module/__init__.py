"""`mx.mod` namespace (parity: python/mxnet/module/__init__.py).
``BucketingModule`` waits for the RNN toolkit (ROADMAP.md, queue item 7)."""
from .base_module import BaseModule
from .module import Module
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
from . import executor_group
