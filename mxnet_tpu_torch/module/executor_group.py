"""``_split_input_slice`` and ``DataParallelExecutorGroup`` (parity:
python/mxnet/module/executor_group.py).

The counterpart of ``mxnet_tpu/module/executor_group.py``.  The port runs a
Module on one device, so the group is that one Module; a group over more
than one device raises (``Module`` names ROADMAP.md's queue item 6).
"""
from __future__ import annotations

from typing import List

from ..base import MXNetError


def _split_input_slice(batch_size: int, work_load_list: List[float]):
    """The batch cut into one slice per device, sized by work load
    (parity: python/mxnet/executor_manager.py:_split_input_slice)."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(work_load * batch_size / total_work_load)
                      for work_load in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise MXNetError("Too many slices; some splits are empty")
        slices.append(slice(begin, end))
    return slices


class DataParallelExecutorGroup:
    """The group as one Module on its context (source parity)."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None):
        from .module import Module
        data_names = [d[0] if isinstance(d, tuple) else d.name
                      for d in data_shapes]
        label_names = [d[0] if isinstance(d, tuple) else d.name
                       for d in (label_shapes or [])]
        self._module = Module(symbol, data_names, label_names,
                              context=contexts,
                              fixed_param_names=fixed_param_names,
                              state_names=state_names)
        self._module.bind(data_shapes, label_shapes, for_training,
                          inputs_need_grad, grad_req=grad_req)

    def forward(self, data_batch, is_train=None):
        self._module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._module.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        return self._module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._module.update_metric(eval_metric, labels)
