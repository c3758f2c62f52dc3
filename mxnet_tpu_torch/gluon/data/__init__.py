"""gluon.data (parity: python/mxnet/gluon/data/__init__.py): datasets,
samplers and the DataLoader.  ``RecordFileDataset`` waits for
``recordio``; the prefetcher and the vision datasets are not ported yet
(ROADMAP.md, queue item 8)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader, default_batchify_fn
