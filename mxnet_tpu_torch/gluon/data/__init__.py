"""gluon.data (parity: python/mxnet/gluon/data/__init__.py): datasets,
samplers, the DataLoader, the ``vision`` datasets, and the prefetcher
(``AsyncPrefetcher``, ``prefetch_to_device``) with its fault containment."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision
from .prefetcher import AsyncPrefetcher, prefetch_to_device
