"""The port's ``io`` (datasets, samplers, DataLoader) against the JAX
package's ``paddle.io`` on the CPU.

Exact throughout: index orders, sample values and batch values are
integers or copied floats.  The samplers equal JAX's orders under one
NumPy seed; the loader's batches equal JAX's in the synchronous,
threaded and process modes (the threaded iterable mode delivers in
completion order, so its batches are compared as a set); and the worker
semantics of ``tests/test_dataloader_workers.py`` hold in the port:
worker info, iterable shards and tails, error propagation, a failing
``worker_init_fn``, timeouts, breaking off and starting a fresh epoch.
Two tests spawn process workers (each child imports torch)."""

import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import random as prandom
from paddle_tpu_torch.observability import metrics as obs_metrics

from _torch_io_util import InfoDS, ShardedIterable
from _torch_port_util import one_thread  # noqa: F401


def _np(x):
    """A batch tree of either package as NumPy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def _assert_tree_equal(a, b, dtypes=True):
    """Equal trees; with ``dtypes`` the leaves' dtypes equal too (JAX
    holds int64 tensors as int32, so tensor rows compare by value)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k], dtypes)
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_tree_equal(u, v, dtypes)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert not dtypes or a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- samplers
SAMPLERS = {
    "sequence": lambda m, d: m.SequenceSampler(d),
    "random": lambda m, d: m.RandomSampler(d),
    "random_replacement": lambda m, d: m.RandomSampler(
        d, replacement=True, num_samples=30),
    "random_num_samples": lambda m, d: m.RandomSampler(d, num_samples=7),
    "weighted": lambda m, d: m.WeightedRandomSampler(
        np.linspace(0.1, 2.0, 23), 40),
    "weighted_no_replacement": lambda m, d: m.WeightedRandomSampler(
        np.linspace(0.1, 2.0, 23), 10, replacement=False),
    "subset_random": lambda m, d: m.SubsetRandomSampler([3, 9, 1, 22, 5]),
    "batch_shuffle": lambda m, d: m.BatchSampler(d, shuffle=True,
                                                 batch_size=5),
    "batch_drop_last": lambda m, d: m.BatchSampler(
        sampler=m.SequenceSampler(d), batch_size=5, drop_last=True),
    "distributed_r0": lambda m, d: m.DistributedBatchSampler(
        d, 4, num_replicas=3, rank=0),
    "distributed_r2_shuffle": lambda m, d: m.DistributedBatchSampler(
        d, 4, num_replicas=3, rank=2, shuffle=True),
    "distributed_r1_drop_last": lambda m, d: m.DistributedBatchSampler(
        d, 3, num_replicas=2, rank=1, shuffle=True, drop_last=True),
}


@pytest.mark.parametrize("kind", sorted(SAMPLERS))
def test_sampler_orders_match_jax(kind):
    data = list(range(23))
    orders = []
    for mod in (jio, tio):
        s = SAMPLERS[kind](mod, data)
        np.random.seed(11)
        epochs = []
        for epoch in range(2):
            if hasattr(s, "set_epoch"):
                s.set_epoch(epoch + 3)
            epochs.append(list(s))
        orders.append((epochs, len(s)))
    assert orders[0] == orders[1]


# ------------------------------------------------------------- datasets
def _datasets(mod, arrays):
    class Squares(mod.Dataset):
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return np.asarray([i * i], np.int64), float(i)

    class Count(mod.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))

    return {
        "tensor": mod.TensorDataset(arrays),
        "compose": mod.ComposeDataset([Squares(), mod.TensorDataset(
            [a[:5] for a in arrays])]),
        "zip": mod.ZipDataset([Squares(), mod.TensorDataset(arrays)]),
        "concat": mod.ConcatDataset([Squares(), mod.TensorDataset(arrays)]),
        "subset": mod.Subset(mod.TensorDataset(arrays), [6, 0, 3]),
        "chain": mod.ChainDataset([Count(3), Count(2)]),
    }


@pytest.mark.parametrize("name", ["tensor", "compose", "zip", "concat",
                                  "subset", "chain"])
def test_datasets_match_jax(name):
    import paddle_tpu as paddle

    r = np.random.RandomState(0)
    x = r.randn(8, 3).astype(np.float32)
    y = r.randint(0, 5, (8,)).astype(np.int64)
    jd = _datasets(jio, [paddle.to_tensor(x), paddle.to_tensor(y)])[name]
    td = _datasets(tio, [torch.from_numpy(x), torch.from_numpy(y)])[name]
    if name == "chain":     # no len(): list() would ask for it
        assert [v for v in jd] == [v for v in td]
        return
    assert len(jd) == len(td)
    for i in list(range(len(td))) + ([-1, -len(td)] if name == "concat"
                                      else []):
        _assert_tree_equal(_np(td[i]), _np(jd[i]), dtypes=False)


def test_random_split_is_a_seeded_partition():
    """The port draws the permutation from its own counter stream (JAX's
    comes from threefry bits): a partition of the right sizes, equal
    under one seed, another under another seed."""
    ds = tio.TensorDataset([torch.arange(20)])

    def split(seed, lengths):
        prandom.seed(seed)
        return [s.indices for s in tio.random_split(ds, lengths)]

    a = split(3, [5, 7, 8])
    assert [len(p) for p in a] == [5, 7, 8]
    assert sorted(sum(a, [])) == list(range(20))
    assert split(3, [5, 7, 8]) == a
    assert split(4, [5, 7, 8]) != a
    frac = split(3, [0.3, 0.3, 0.4])
    assert [len(p) for p in frac] == [6, 6, 8]
    with pytest.raises(ValueError):
        tio.random_split(ds, [5, 5])


# ------------------------------------------------------------- loader
def _map_ds(mod):
    class Rows(mod.Dataset):
        def __len__(self):
            return 19

        def __getitem__(self, i):
            r = np.random.RandomState(i)
            return (r.randn(2, 3).astype(np.float32), int(i % 4),
                    {"w": float(i) / 3, "name": f"s{i}"})

    return Rows()


def _iter_ds(mod):
    class Stream(mod.IterableDataset):
        def __iter__(self):
            info = (jio.get_worker_info() if mod is jio
                    else tio.get_worker_info())
            lo, step = (0, 1) if info is None else (info.id,
                                                    info.num_workers)
            for i in range(lo, 21, step):
                yield np.asarray([i, 2 * i], np.int64), i

    return Stream()


LOADER_MODES = {
    "sync": dict(num_workers=0),
    "threads": dict(num_workers=3, prefetch_factor=1),
    "sync_shuffle_drop_last": dict(num_workers=0, shuffle=True,
                                   drop_last=True),
    "threads_shuffle": dict(num_workers=2, shuffle=True),
}


@pytest.mark.parametrize("mode", sorted(LOADER_MODES))
def test_loader_batches_match_jax(mode):
    kw = dict(batch_size=4, **LOADER_MODES[mode])
    batches = []
    for mod in (jio, tio):
        np.random.seed(5)
        extra = {"places": "cpu"} if mod is tio else {}
        dl = mod.DataLoader(_map_ds(mod), **kw, **extra)
        batches.append([_np(b) for b in dl])
        assert len(dl) == len(batches[-1])
    assert len(batches[0]) == len(batches[1])
    for jb, tb in zip(*batches):
        _assert_tree_equal(tb, jb)


@pytest.mark.parametrize("workers", [0, 2], ids=["sync", "threads"])
def test_iterable_loader_batches_match_jax(workers):
    got = []
    for mod in (jio, tio):
        extra = {"places": "cpu"} if mod is tio else {}
        dl = mod.DataLoader(_iter_ds(mod), batch_size=4,
                            num_workers=workers, **extra)
        got.append([_np(b) for b in dl])
    if workers:          # completion order: compare as a set of batches
        key = lambda b: b[0][0, 0]          # noqa: E731
        got = [sorted(g, key=key) for g in got]
    assert len(got[0]) == len(got[1])
    for jb, tb in zip(*got):
        _assert_tree_equal(tb, jb, dtypes=False)


def test_default_collate_matches_jax():
    batch = [(np.ones((2,), np.float32) * i, i, float(i), "t",
              {"k": np.int64(i)}) for i in range(3)]
    _assert_tree_equal(_np(tio.default_collate_fn(batch)),
                       _np(jio.default_collate_fn(batch)))
    out = tio.default_collate_fn(batch)
    assert out[1].dtype == torch.int32 and out[2].dtype == torch.float32
    assert out[3] == ["t", "t", "t"]


def test_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.DataLoader(_map_ds(tio), batch_size=2)


def test_loader_publishes_its_metrics():
    batches = obs_metrics.counter("dataloader.batches")
    stall = obs_metrics.histogram("dataloader.stall_seconds")
    n0 = batches.value(workers="threads")
    s0 = (stall.stats(workers="threads") or {"count": 0})["count"]
    dl = tio.DataLoader(_map_ds(tio), batch_size=4, num_workers=2,
                        places="cpu")
    n = len(list(dl))
    assert batches.value(workers="threads") - n0 == n == 5
    assert stall.stats(workers="threads")["count"] - s0 == n


# ------------------------------------------------ worker semantics
def _bad_init(wid):
    raise ValueError("init boom")


def test_worker_info_in_threads_and_none_outside():
    assert tio.get_worker_info() is None
    dl = tio.DataLoader(InfoDS(), batch_size=4, num_workers=2, places="cpu")
    rows = np.concatenate([b.numpy() for b in dl])
    np.testing.assert_array_equal(rows[:, 0], np.arange(16))
    assert set(rows[:, 1]) <= {0, 1} and set(rows[:, 2]) == {2}
    assert tio.get_worker_info() is None


def test_process_workers_match_jax_batches():
    """Spawned children see their WorkerInfo, ship NumPy, and the batches
    come back in sampler order with JAX's values."""
    dl = tio.DataLoader(InfoDS(), batch_size=4, num_workers=2,
                        use_process_workers=True, timeout=120,
                        places="cpu")
    got = [b.numpy() for b in dl]
    rows = np.concatenate(got)
    np.testing.assert_array_equal(rows[:, 0], np.arange(16))
    assert set(rows[:, 2]) == {2}
    assert all(b.dtype == np.int64 and b.shape == (4, 3) for b in got)


def test_process_iterable_workers_cover_disjoint_shards():
    dl = tio.DataLoader(ShardedIterable(32), batch_size=4, num_workers=2,
                        use_process_workers=True, timeout=120, places="cpu")
    rows = np.concatenate([b.numpy() for b in dl])
    np.testing.assert_array_equal(np.sort(rows[:, 0]), np.arange(32))
    assert os.getpid() not in set(rows[:, 1].tolist())


@pytest.mark.parametrize("n,drop_last,sizes", [
    (32, False, [4] * 8), (30, False, [3, 3] + [4] * 6),
    (30, True, [4] * 6)], ids=["even", "tails", "drop_last"])
def test_threaded_iterable_shards_and_tails(n, drop_last, sizes):
    dl = tio.DataLoader(ShardedIterable(n), batch_size=4, num_workers=2,
                        drop_last=drop_last, places="cpu")
    got = [b.numpy() for b in dl]
    assert sorted(len(b) for b in got) == sizes
    ids = np.sort(np.concatenate(got)[:, 0])
    np.testing.assert_array_equal(
        ids, np.sort(np.concatenate([np.arange(w, n, 2)[:len(ids) // 2]
                                     for w in range(2)])) if drop_last
        else np.arange(n))


class _Boom(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom")
        return np.zeros(2, np.float32)


class _BadIterable(tio.IterableDataset):
    def __iter__(self):
        yield np.zeros(2, np.float32)
        raise ValueError("boom")


@pytest.mark.parametrize("case", ["map_threads", "iterable_threads",
                                  "iterable_sync", "map_sync"])
def test_errors_propagate(case):
    ds = _BadIterable() if case.startswith("iterable") else _Boom()
    dl = tio.DataLoader(ds, batch_size=2, places="cpu",
                        num_workers=2 if case.endswith("threads") else 0)
    with pytest.raises(ValueError, match="boom"):
        list(dl)


@pytest.mark.parametrize("iterable", [False, True], ids=["map", "iterable"])
def test_worker_init_fn_failure_raises(iterable):
    ds = ShardedIterable(8) if iterable else InfoDS()
    dl = tio.DataLoader(ds, batch_size=2, num_workers=2,
                        worker_init_fn=_bad_init, timeout=60, places="cpu")
    with pytest.raises(ValueError, match="init boom"):
        list(dl)


class _Slow(tio.Dataset):
    def __init__(self, release):
        self.release = release

    def __len__(self):
        return 4

    def __getitem__(self, i):
        self.release.wait(30)
        return np.zeros(1, np.float32)


class _SlowIterable(tio.IterableDataset):
    def __init__(self, release):
        self.release = release

    def __iter__(self):
        self.release.wait(30)
        yield np.zeros(1, np.float32)


@pytest.mark.parametrize("iterable", [False, True], ids=["map", "iterable"])
def test_timeout_is_honoured(iterable):
    release = threading.Event()
    ds = _SlowIterable(release) if iterable else _Slow(release)
    dl = tio.DataLoader(ds, batch_size=1, num_workers=1, timeout=1,
                        places="cpu")
    t0 = time.monotonic()
    timer = threading.Timer(1.5, release.set)    # after the 1 s timeout
    timer.start()
    try:
        with pytest.raises(RuntimeError, match="timed out"):
            list(dl)
    finally:
        release.set()
        timer.cancel()
    assert time.monotonic() - t0 < 10


@pytest.mark.parametrize("iterable", [False, True], ids=["map", "iterable"])
def test_break_then_fresh_epoch(iterable):
    ds = ShardedIterable(64) if iterable else InfoDS()
    dl = tio.DataLoader(ds, batch_size=4, num_workers=2, places="cpu")
    it = iter(dl)
    next(it)
    it.close()
    rows = np.concatenate([b.numpy() for b in dl])
    np.testing.assert_array_equal(np.sort(rows[:, 0]),
                                  np.arange(64 if iterable else 16))


def test_thread_workers_can_mutate_their_dataset_copy():
    class MutShard(tio.IterableDataset):
        def __init__(self, n):
            self.n, self.lo, self.step = n, 0, 1

        def __iter__(self):
            info = tio.get_worker_info()
            if info is not None:
                ds = info.dataset
                ds.lo, ds.step = info.id, info.num_workers
            for i in range(self.lo if info is None else info.dataset.lo,
                           self.n, self.step if info is None
                           else info.dataset.step):
                yield np.asarray([i], np.int64)

    dl = tio.DataLoader(MutShard(24), batch_size=3, num_workers=2,
                        places="cpu")
    rows = np.concatenate([b.numpy() for b in dl])
    np.testing.assert_array_equal(np.sort(rows[:, 0]), np.arange(24))
