"""TensorBoard bridge (parity: ``mxnet_tpu/contrib/tensorboard.py``)."""
from __future__ import annotations


class LogMetricsCallback:
    """Log the eval metric to a TensorBoard event file at each batch end,
    through tensorboardX or torch's ``SummaryWriter``; raises ImportError
    when neither is installed."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                raise ImportError(
                    "tensorboard writer not available; install tensorboardX "
                    "or use torch's SummaryWriter") from None
        self.summary_writer = SummaryWriter(logging_dir)

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = f"{self.prefix}-{name}"
            self.summary_writer.add_scalar(name, value)
