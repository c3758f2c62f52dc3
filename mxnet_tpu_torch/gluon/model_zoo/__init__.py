"""Model zoo of the port: the transformer language model."""
from . import transformer
from .transformer import TransformerLM, transformer_lm
