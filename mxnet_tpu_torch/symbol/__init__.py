"""`mx.sym` namespace (parity: python/mxnet/symbol/__init__.py): Symbol
constructors, one function per registered operator, and ``GraphPlan``."""
from .. import ops  # registers all operators
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     zeros, ones, arange)
from . import register
from .register import invoke_symbol, populate

populate(globals())

# scalar/Symbol-dispatching free functions AFTER the op functions so they
# shadow the generated wrappers of the same name (which take no scalars)
from .symbol import pow, maximum, minimum, hypot  # noqa: E402

from . import graph  # noqa: E402
from .graph import GraphPlan  # noqa: E402
