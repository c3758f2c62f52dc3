"""Operator definitions; importing this package registers every op."""
from . import registry
from . import elemwise, reduce, matrix, nn, flash_attention, init_ops
