"""Datasets, the counterparts of ``paddle_tpu/io/dataset.py``.

The same classes and index arithmetic.  ``TensorDataset`` takes torch
tensors or numpy arrays; a sample is their rows at one index.

``random_split`` draws its permutation from the port's counter stream
(one key, as JAX's ``paddle.randperm`` takes one from its stream), so a
split is seeded by :func:`paddle_tpu_torch.random.seed`.  Its order is
not JAX's: JAX permutes with threefry bits, which the port does not
compute (as sampled tokens differ, ``serving/sampling.py``).
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from .. import random as _random


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        if any(len(t) != len(tensors[0]) for t in tensors):
            raise ValueError("TensorDataset: tensors differ in length")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        if any(len(d) != len(self.datasets[0]) for d in self.datasets):
            raise ValueError("ComposeDataset: datasets differ in length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ZipDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        return tuple(d[idx] for d in self.datasets)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        start = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - start]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of ``lengths`` (counts, or fractions summing to 1 with the
    remainder on the last) over one random permutation of the indices."""
    if all(isinstance(n, float) for n in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        n = len(dataset)
        lengths = [int(f * n) for f in lengths]
        lengths[-1] += n - sum(lengths)
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    perm = torch.randperm(total, generator=_random.next_generator(
        "cpu")).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out
