"""gluon.data (parity: python/mxnet/gluon/data/__init__.py): datasets,
samplers, the DataLoader and the ``vision`` datasets.  The prefetcher waits
for the observability and fault-injection modules it reads (ROADMAP.md,
queue item 5)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision
