"""``paddle_tpu_torch.io``, the counterpart of ``paddle_tpu/io``: datasets,
samplers and the DataLoader (``record.py`` and ``reader_compat.py`` are
not ported yet)."""

from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info)
from .dataset import (
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, ZipDataset, random_split,
)
from .sampler import (
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "WorkerInfo",
           "ZipDataset", "default_collate_fn", "get_worker_info",
           "random_split"]
