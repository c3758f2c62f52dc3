"""gluon.data.DataLoader (parity: python/mxnet/gluon/data/dataloader.py).

The counterpart of ``mxnet_tpu/gluon/data/dataloader.py``: a batch sampler
over a dataset, ``default_batchify_fn`` to stack each batch, and with
``num_workers > 0`` a thread pool that builds batches ahead (the reference
forks worker processes and ships batches through shared memory).  Numpy
samples are stacked on the host and uploaded once per batch to the current
context, ``gpu(0)`` unless the caller enters another (``with mx.cpu():``);
with no CUDA device that raises, as every entry point of the port does.
Tensor samples are stacked where they lie.
"""
from __future__ import annotations

import concurrent.futures as _futures

import numpy as _np
import torch

from ... import ndarray as nd
from ...context import current_context
from .sampler import BatchSampler, RandomSampler, SequentialSampler


def default_batchify_fn(data):
    """Stack samples into a batch; a sample that is a tuple gives a list
    of batches, one per field."""
    if isinstance(data[0], torch.Tensor):
        return torch.stack(data)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = _np.asarray(data)
    return nd.array(data, dtype=data.dtype)


# the reference's multiprocessing batchify stacks the same way
default_mp_batchify_fn = default_batchify_fn


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._batchify_fn([self._dataset[idx] for idx in batch])
            return
        # the workers run under the iterating thread's context
        ctx = current_context()

        def build(batch):
            with ctx:
                return self._batchify_fn([self._dataset[i] for i in batch])

        with _futures.ThreadPoolExecutor(self._num_workers) as pool:
            futures = [pool.submit(build, batch)
                       for batch in self._batch_sampler]
            for fut in futures:
                yield fut.result()

    def __len__(self):
        return len(self._batch_sampler)
