"""``paddle_tpu_torch.io``, the counterpart of ``paddle_tpu/io``: datasets,
samplers, the DataLoader, the ``PTRECD01`` record file and ``batch``."""

from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info)
from .dataset import (
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, ZipDataset, random_split,
)
from .reader_compat import batch
from .record import RecordDataset, RecordFile, RecordWriter
from .sampler import (
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset", "RecordDataset",
           "RecordFile", "RecordWriter",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "WorkerInfo",
           "ZipDataset", "batch", "default_collate_fn", "get_worker_info",
           "random_split"]
