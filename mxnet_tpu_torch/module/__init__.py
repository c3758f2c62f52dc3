"""`mx.mod` namespace (parity: python/mxnet/module/__init__.py)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
from . import executor_group
