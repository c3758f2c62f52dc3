"""The old contrib autograd API (parity: ``mxnet_tpu/contrib/autograd.py``):
``train_section`` is ``autograd.record``, ``test_section`` is
``autograd.pause``."""
from ..autograd import (record as train_section, pause as test_section,
                        set_recording, is_recording, mark_variables,
                        backward, grad)


def compute_gradient(outputs):
    """Backward from ``outputs``; returns their gradients (None for an
    output that is no attached variable, as in the JAX package)."""
    backward(outputs)
    return [o.grad if o.is_leaf else None for o in outputs]
