"""Model zoo of the port: the vision families and the transformer language
model (parity: python/mxnet/gluon/model_zoo/__init__.py)."""
from . import vision
from . import transformer
from .vision import get_model
from .transformer import TransformerLM, transformer_lm
