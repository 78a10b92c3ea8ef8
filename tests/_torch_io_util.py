"""Datasets of the port's DataLoader tests that spawned worker processes
unpickle: this module imports numpy and the port's ``io`` only, so a
child starts without JAX."""

import os

import numpy as np

from paddle_tpu_torch.io import Dataset, IterableDataset, get_worker_info


class InfoDS(Dataset):
    """Map-style: each sample records its index and the WorkerInfo seen."""

    def __len__(self):
        return 16

    def __getitem__(self, i):
        info = get_worker_info()
        if info is None:
            raise RuntimeError("worker info missing inside a worker")
        return np.asarray([i, info.id, info.num_workers], np.int64)


class ShardedIterable(IterableDataset):
    """Shards itself through get_worker_info (the reference contract)."""

    def __init__(self, n=32):
        self.n = n

    def __iter__(self):
        info = get_worker_info()
        lo, step = (0, 1) if info is None else (info.id, info.num_workers)
        for i in range(lo, self.n, step):
            yield np.asarray([i, os.getpid()], np.int64)
