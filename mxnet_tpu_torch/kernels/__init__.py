"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version, counts its
launches in a module integer ``LAUNCHES`` and builds its library on first
use (``_build``).  ``ALL`` lists every wrapper module of the port.
"""
from . import add_one, flash_attention, nms, roi_pooling

ALL = (add_one, flash_attention, nms, roi_pooling)
