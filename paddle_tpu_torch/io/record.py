"""The ``PTRECD01`` record file, the counterpart of
``paddle_tpu/io/record.py``: ``RecordWriter`` builds one,
``RecordFile`` reads it by index and ``RecordDataset`` serves it to the
``DataLoader``.

Format (the JAX package's, byte for byte): the 8-byte magic
``PTRECD01``, then per record its length as a little-endian u64 and its
payload.  The JAX package reads through its C++ library
(``paddle_tpu.native``); the port does not load it: ``RecordFile`` scans
the record headers once when opened and reads payloads with
``os.pread`` (no shared file offset, so reads from several threads need
no lock), ``read_batch`` on a thread pool of ``num_threads`` workers
(``0``: one a CPU, at most 8) into one contiguous buffer.  A truncated
last record is left out of the index, as JAX's scan does.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .dataset import Dataset

_MAGIC = b"PTRECD01"


class RecordWriter:
    def __init__(self, path):
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._n = 0

    def write(self, payload):
        """Append one record (bytes, a bytes-like object or a numpy
        array's buffer); returns its index."""
        if isinstance(payload, np.ndarray):
            payload = payload.tobytes()
        b = bytes(payload)
        self._f.write(struct.pack("<Q", len(b)))
        self._f.write(b)
        self._n += 1
        return self._n - 1

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _scan(fd, path):
    """[(offset, length)] of every whole record of the open file."""
    if os.pread(fd, 8, 0) != _MAGIC:
        raise ValueError(f"{path!r} is not a PTRECD01 record file")
    idx = []
    off, end = 8, os.fstat(fd).st_size
    while off + 8 <= end:
        (ln,) = struct.unpack("<Q", os.pread(fd, 8, off))
        off += 8
        if off + ln > end:
            break
        idx.append((off, ln))
        off += ln
    return idx


class RecordFile:
    """Indexed reader over a ``PTRECD01`` file."""

    def __init__(self, path, num_threads=0):
        self.path = path
        self._threads = num_threads or min(8, os.cpu_count() or 1)
        self._fd = os.open(path, os.O_RDONLY)
        self._pool = None
        try:
            self._index = _scan(self._fd, path)
        except BaseException:
            self.close()
            raise

    def __len__(self):
        return len(self._index)

    def size(self, i):
        return self._index[i][1]

    def _fd_open(self):
        if self._fd is None:
            self._fd = os.open(self.path, os.O_RDONLY)
        return self._fd

    def _pread(self, i, out=None):
        off, ln = self._index[i]
        data = os.pread(self._fd_open(), ln, off)
        if len(data) != ln:
            raise OSError(f"{self.path!r}: record {i} short read "
                          f"({len(data)} of {ln} bytes)")
        if out is not None:
            out[:] = np.frombuffer(data, np.uint8)
        return data

    def read(self, i):
        """One record as bytes."""
        return self._pread(i)

    def read_batch(self, indices):
        """Many records read in parallel into ONE contiguous buffer;
        returns (buffer, offsets, sizes): record k is
        ``buffer[offsets[k]:offsets[k] + sizes[k]]``."""
        indices = [int(i) for i in indices]
        sizes = np.asarray([self.size(i) for i in indices], np.uint64)
        offsets = np.zeros(len(indices), np.uint64)
        if len(indices) > 1:
            offsets[1:] = np.cumsum(sizes[:-1])
        buf = np.empty(int(sizes.sum()), np.uint8)
        views = [buf[int(o):int(o) + int(s)] for o, s in zip(offsets, sizes)]
        if len(indices) > 1 and self._threads > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self._threads)
            for f in [self._pool.submit(self._pread, i, v)
                      for i, v in zip(indices, views)]:
                f.result()
        else:
            for i, v in zip(indices, views):
                self._pread(i, v)
        return buf, offsets, sizes

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __getstate__(self):
        # a process worker reopens the file; descriptors and threads do
        # not travel
        state = dict(self.__dict__)
        state["_fd"] = state["_pool"] = None
        return state

    def __del__(self):
        self.close()


class RecordDataset(Dataset):
    """A Dataset over a record file.  ``decode_fn(bytes) -> sample``
    defaults to the bytes themselves; ``ndarray_spec=(dtype, shape)``
    decodes fixed-shape arrays."""

    def __init__(self, path, decode_fn=None, ndarray_spec=None,
                 num_threads=0):
        self._rf = RecordFile(path, num_threads=num_threads)
        self._decode = decode_fn
        self._spec = ndarray_spec

    def __len__(self):
        return len(self._rf)

    def __getitem__(self, i):
        raw = self._rf.read(i)
        if self._spec is not None:
            dtype, shape = self._spec
            return np.frombuffer(raw, dtype=dtype).reshape(shape)
        if self._decode is not None:
            return self._decode(raw)
        return raw

    def read_batch(self, indices):
        """A packed batch: for fixed-shape ndarray records one ``[n,
        *shape]`` array over a single buffer, else a list of samples."""
        buf, offsets, sizes = self._rf.read_batch(indices)
        if self._spec is not None:
            dtype, shape = self._spec
            per = int(np.prod(shape)) * np.dtype(dtype).itemsize
            if not all(int(s) == per for s in sizes):
                raise ValueError("records do not match ndarray_spec")
            return buf.view(dtype).reshape((len(indices),) + tuple(shape))
        out = []
        for k in range(len(indices)):
            o = int(offsets[k])
            raw = buf[o:o + int(sizes[k])].tobytes()
            out.append(self._decode(raw) if self._decode else raw)
        return out
