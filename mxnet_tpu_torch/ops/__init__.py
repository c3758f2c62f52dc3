"""Operator definitions; importing this package registers every op."""
from . import registry
from . import (elemwise, reduce, matrix, nn, flash_attention, init_ops,
               optimizer_ops, random_ops, sequence, contrib, vision, compat,
               custom)

compat.register_aliases()
