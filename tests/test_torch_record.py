"""The port's ``io.record`` (``RecordWriter``, ``RecordFile``,
``RecordDataset``) and ``batch`` against the JAX package's, on the CPU:
the ``PTRECD01`` bytes written by one read back byte for byte by the
other; ``read_batch`` packing; a ``RecordDataset`` through the port's
``DataLoader`` (synchronous and thread workers); a truncated last record
left out of the index; ``paddle_tpu_torch.batch`` against
``paddle_tpu.batch``.  Exact comparisons throughout (bytes and
integers)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.io import record as jrec
import paddle_tpu_torch as pt
from paddle_tpu_torch.io import (
    DataLoader, RecordDataset, RecordFile, RecordWriter,
)

from _torch_port_util import one_thread  # noqa: F401


def _records(n=12):
    r = np.random.RandomState(0)
    return [r.randn(3, 5).astype(np.float32) for _ in range(n)] + \
        [b"", b"ragged bytes \x00\x01"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_are_the_same_bytes_and_read_back(tmp_path, writer):
    recs = _records()
    paths = {}
    for name, cls in (("jax", jrec.RecordWriter), ("port", RecordWriter)):
        paths[name] = str(tmp_path / f"{name}.ptrec")
        with cls(paths[name]) as w:
            for i, rec in enumerate(recs):
                assert w.write(rec) == i
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    path = paths[writer]
    port, jax_rf = RecordFile(path), jrec.RecordFile(path)
    assert len(port) == len(jax_rf) == len(recs)
    for i, rec in enumerate(recs):
        want = rec.tobytes() if isinstance(rec, np.ndarray) else rec
        assert port.size(i) == jax_rf.size(i) == len(want)
        assert port.read(i) == jax_rf.read(i) == want
    idx = [13, 0, 5, 5, 12]
    for got, want in zip(port.read_batch(idx), jax_rf.read_batch(idx)):
        np.testing.assert_array_equal(got, want)
    port.close()
    jax_rf.close()


def test_dataset_read_batch_and_loader(tmp_path):
    recs = _records()[:12]
    path = str(tmp_path / "data.ptrec")
    with RecordWriter(path) as w:
        for rec in recs:
            w.write(rec)
    ds = RecordDataset(path, ndarray_spec=(np.float32, (3, 5)),
                       num_threads=3)
    assert len(ds) == 12
    np.testing.assert_array_equal(ds[4], recs[4])
    np.testing.assert_array_equal(ds.read_batch([2, 9, 0]),
                                  np.stack([recs[2], recs[9], recs[0]]))
    jds = jrec.RecordDataset(path, ndarray_spec=(np.float32, (3, 5)))
    np.testing.assert_array_equal(ds.read_batch(range(12)),
                                  jds.read_batch(range(12)))
    for workers in (0, 2):
        dl = DataLoader(ds, places="cpu", batch_size=4, num_workers=workers)
        got = [b for b in dl]
        assert [tuple(b.shape) for b in got] == [(4, 3, 5)] * 3
        torch.testing.assert_close(torch.cat(got),
                                   torch.from_numpy(np.stack(recs)),
                                   rtol=0, atol=0)
    raw = RecordDataset(path, decode_fn=lambda b: len(b))
    assert raw[0] == 60 and raw.read_batch([1, 2]) == [60, 60]
    with pytest.raises(ValueError, match="ndarray_spec"):
        RecordDataset(path, ndarray_spec=(np.float32, (2, 5))).read_batch(
            [0])


def test_truncated_tail_and_bad_magic(tmp_path):
    path = str(tmp_path / "t.ptrec")
    with RecordWriter(path) as w:
        w.write(b"abc")
        w.write(b"defgh")
    with open(path, "ab") as f:
        f.write(np.uint64(100).tobytes() + b"short")
    assert len(RecordFile(path)) == len(jrec.RecordFile(path)) == 2
    bad = str(tmp_path / "bad.ptrec")
    with open(bad, "wb") as f:
        f.write(b"NOTAREC!")
    with pytest.raises(ValueError, match="PTRECD01"):
        RecordFile(bad)


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_matches_paddle_batch(drop_last):
    reader = lambda: iter(range(10))
    want = list(paddle.batch(reader, 3, drop_last=drop_last)())
    assert list(pt.batch(reader, 3, drop_last=drop_last)()) == want
    assert list(pt.io.batch(reader, 5)()) == [[0, 1, 2, 3, 4],
                                              [5, 6, 7, 8, 9]]
