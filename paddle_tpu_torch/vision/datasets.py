"""Vision datasets, the counterparts of ``paddle_tpu/vision/datasets.py``:
``FakeData`` (at most 64 distinct images drawn by ``RandomState(seed)``,
labels beside them: the same arrays as JAX's under one seed) and
``MNIST``, ``Cifar10``, ``Cifar100`` and ``DatasetFolder``, which read
local files only (no download).  Samples are NumPy arrays; the
DataLoader turns batches into tensors on its ``places``."""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ..io.dataset import Dataset


class FakeData(Dataset):
    """Synthetic image classification dataset (benchmark feeder)."""

    def __init__(self, size=1000, image_shape=(3, 224, 224), num_classes=1000,
                 transform=None, seed=0):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.rng = np.random.RandomState(seed)
        self._images = self.rng.rand(min(size, 64), *self.image_shape
                                     ).astype(np.float32)
        self._labels = self.rng.randint(0, num_classes, size=size
                                        ).astype(np.int32)

    def __getitem__(self, idx):
        img = self._images[idx % len(self._images)]
        if self.transform:
            img = self.transform(img)
        return img, self._labels[idx]

    def __len__(self):
        return self.size


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        if image_path is None or not os.path.exists(image_path):
            raise FileNotFoundError(
                "MNIST reads local idx files: pass image_path/label_path "
                "explicitly"
            )
        self.transform = transform
        with _open(image_path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(f.read(), np.uint8).reshape(
                n, rows, cols)
        with _open(label_path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int32)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None or not os.path.exists(data_file):
            raise FileNotFoundError(
                "Cifar10 reads a local pickle batch file: pass data_file"
            )
        with open(data_file, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        self.images = batch[b"data"].reshape(-1, 3, 32, 32)
        self.labels = np.asarray(batch[b"labels"], np.int32)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    pass


class DatasetFolder(Dataset):
    """Image-folder dataset over ``.npy`` arrays (another format needs a
    ``loader``: no image decoder ships with the port)."""

    def __init__(self, root, loader=None, extensions=(".npy",), transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for fn in sorted(os.listdir(d)):
                if fn.endswith(tuple(extensions)):
                    self.samples.append((os.path.join(d, fn),
                                         self.class_to_idx[c]))
        self.loader = loader or np.load

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder
