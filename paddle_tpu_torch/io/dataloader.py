"""DataLoader, the counterpart of ``paddle_tpu/io/dataloader.py``.

The same four iteration modes, batch order and failure rules: in the
calling thread (``num_workers=0``); worker threads over a batch sampler
(``_iter_threaded``, batches in sampler order); spawn-context process
workers (``use_process_workers=True``, ``_iter_process``); and for an
``IterableDataset`` the threaded and process paths where each worker
iterates its own copy of the dataset and shards it through
:func:`get_worker_info` (batches in completion order).  A worker's
exception, a failing ``worker_init_fn`` and a dead process raise in the
consumer; ``timeout`` bounds each wait for a batch.

Where JAX's collate puts arrays on the TPU, the port's puts batches on
``places`` (the card unless the caller passes ``"cpu"``): a worker
collates on the host to NumPy (:func:`default_collate_fn`: int samples
as int32 and floats as float32, as JAX's), wraps the arrays as CPU
tensors and pins them when ``places`` is a card; the consuming thread
copies each to the card with ``non_blocking=True``.  The loader keeps the
pinned source of every copy, beside an event recorded after it, until
that event has completed, so a pinned buffer is never freed (and reused)
while its copy may still read it.  Process workers ship NumPy, as JAX's
do, and start from ``spawn``: forking after CUDA has started is unsafe.

The input pipeline publishes JAX's ``dataloader.*`` families on the
port's ``observability.metrics``: ``queue_depth`` (batches ready when
the consumer took one), ``stall_seconds`` (how long it blocked for it)
and ``batches``, labelled by ``workers`` (``threads`` or ``procs``); a
stall above 1 ms also lands on the event timeline.

``use_shared_memory``, ``use_buffer_reader``, ``persistent_workers``,
``feed_list`` and ``return_list`` are accepted and ignored, as in JAX.
"""

from __future__ import annotations

import collections
import copy
import queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics
from .dataset import IterableDataset
from .sampler import BatchSampler

_DL_QUEUE_DEPTH = _obs_metrics.gauge(
    "dataloader.queue_depth", "prefetched batches ready at consume time")
_DL_STALL_SECONDS = _obs_metrics.histogram(
    "dataloader.stall_seconds",
    "consumer wall seconds blocked waiting for the next batch")
_DL_BATCHES = _obs_metrics.counter(
    "dataloader.batches", "batches delivered to the consumer")
_STALL_EVENT_THRESHOLD_S = 1e-3


def _note_delivery(stall, depth, mode, batch_index):
    _DL_STALL_SECONDS.observe(stall, workers=mode)
    _DL_QUEUE_DEPTH.set(depth, workers=mode)
    _DL_BATCHES.inc(workers=mode)
    if stall > _STALL_EVENT_THRESHOLD_S:
        _obs_events.instant("dataloader.stall", cat="io", workers=mode,
                            seconds=round(stall, 6), batch=batch_index,
                            queue_depth=depth)


class WorkerInfo:
    """Identifies the calling worker inside dataset code: the contract
    ``IterableDataset.__iter__`` uses to shard itself across workers."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset

    def __repr__(self):
        return f"WorkerInfo(id={self.id}, num_workers={self.num_workers})"


_worker_tls = threading.local()
_PROC_WORKER_INFO = None  # set in spawned children


def get_worker_info():
    """Inside a worker (thread or spawned process): its WorkerInfo; in
    the main process: None."""
    info = getattr(_worker_tls, "info", None)
    if info is not None:
        return info
    return _PROC_WORKER_INFO


def _collate_np(batch):
    """Collate samples to a NumPy tree (torch tensors are stacked as
    torch tensors)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (int, np.integer)):
        # int32 as JAX's (x64 off there)
        return np.asarray(batch, np.int32)
    if isinstance(sample, float):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(_collate_np(list(items)) for items in transposed)
    if isinstance(sample, dict):
        return {k: _collate_np([d[k] for d in batch]) for k in sample}
    if isinstance(sample, str):
        return list(batch)
    return np.asarray(batch)


def _map_tree(fn, x):
    """``fn`` over the array and tensor leaves of a tuple/list/dict tree
    (a list of strings is a leaf)."""
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return fn(x)
    if isinstance(x, (list, tuple)) and not (x and isinstance(x[0], str)):
        return type(x)(_map_tree(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map_tree(fn, v) for k, v in x.items()}
    return x


def _as_tensor(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _as_numpy(t):
    """A spawned child ships NumPy; bfloat16 (no NumPy dtype) ships as
    the tensor."""
    if isinstance(t, torch.Tensor) and t.dtype != torch.bfloat16:
        return t.detach().cpu().numpy()
    return t


def _np_to_tensor_tree(x):
    return _map_tree(_as_tensor, x)


def default_collate_fn(batch):
    """Samples to a tree of host (CPU) tensors; the loader moves them to
    its ``places``."""
    return _np_to_tensor_tree(_collate_np(batch))


def _process_worker(dataset, collate_fn, worker_init_fn, worker_id,
                    num_workers, task_q, result_q):
    """Top-level for spawn picklability."""
    global _PROC_WORKER_INFO
    _PROC_WORKER_INFO = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = task_q.get()
        if item is None:
            return
        seq, indices = item
        try:
            out = _map_tree(_as_numpy,
                            collate_fn([dataset[i] for i in indices]))
        except Exception as e:  # noqa: BLE001 — propagate to the consumer
            out = RuntimeError(f"DataLoader worker {worker_id} failed: "
                               f"{type(e).__name__}: {e}")
        result_q.put((seq, out))


def _process_worker_iterable(dataset, collate_fn, worker_init_fn,
                             worker_id, num_workers, batch_size, drop_last,
                             result_q):
    """Iterable-dataset child: iterate THIS worker's replica (sharded by
    the dataset via get_worker_info), collate, ship NumPy batches."""
    global _PROC_WORKER_INFO
    _PROC_WORKER_INFO = WorkerInfo(worker_id, num_workers, dataset)
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        for batch in _batches_from(dataset, batch_size, drop_last):
            result_q.put(("b", _map_tree(_as_numpy, collate_fn(batch))))
    except Exception as e:  # noqa: BLE001
        result_q.put(("e", RuntimeError(
            f"DataLoader worker {worker_id} failed: "
            f"{type(e).__name__}: {e}")))
    result_q.put(("done", worker_id))


def _batches_from(sample_iter, batch_size, drop_last):
    """Samples into lists of ``batch_size`` (the tail kept unless
    ``drop_last``)."""
    batch = []
    for sample in sample_iter:
        batch.append(sample)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class _Copies:
    """The pinned sources of the host-to-card copies still in flight,
    each beside the event recorded after its copies."""

    def __init__(self):
        self._pending = collections.deque()

    def hold(self, host):
        ev = torch.cuda.Event()
        ev.record()
        self._pending.append((ev, host))
        while self._pending and self._pending[0][0].query():
            self._pending.popleft()

    def drain(self):
        while self._pending:
            self._pending.popleft()[0].synchronize()


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process_workers=False):
        """``places``: where batches land, the card unless the caller
        passes ``"cpu"`` (a list or tuple of one place is read as that
        place)."""
        if isinstance(places, (list, tuple)):
            if len(places) != 1:
                raise ValueError("DataLoader takes one place")
            places = places[0]
        self.places = resolve_device(places)
        self._pin = self.places.type == "cuda"
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.timeout = timeout
        self.use_process_workers = use_process_workers
        self.worker_init_fn = worker_init_fn
        self._proc_collate = collate_fn or _collate_np
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_size = batch_size
            self.batch_sampler = None
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("length of IterableDataset DataLoader is unknown")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    # ---------------- host and device halves ----------------
    def _host(self, out):
        """A collated batch as host tensors, pinned for a card."""
        out = _np_to_tensor_tree(out)
        if self._pin:
            out = _map_tree(lambda t: t.pin_memory() if t.device.type ==
                            "cpu" else t, out)
        return out

    def _to_places(self, host, copies):
        """Consumer side: the batch's tensors on ``places``; the copies
        from pinned memory are asynchronous and ``copies`` holds their
        source until they have run."""
        if not self._pin:
            return _map_tree(lambda t: t.to(self.places), host)
        out = _map_tree(lambda t: t.to(self.places, non_blocking=True), host)
        copies.hold(host)
        return out

    def _fetch(self, indices):
        return self._host(self.collate_fn([self.dataset[i] for i in indices]))

    def __iter__(self):
        if self.num_workers and self.num_workers > 0:
            if self._iterable:
                host = (self._iter_process_iterable()
                        if self.use_process_workers
                        else self._iter_threaded_iterable())
            elif self.batch_sampler is not None:
                host = (self._iter_process() if self.use_process_workers
                        else self._iter_threaded())
            else:
                host = self._iter_sync()
        else:
            host = self._iter_sync()
        return self._on_places(host)

    def _on_places(self, host_batches):
        copies = _Copies() if self._pin else None
        try:
            for host in host_batches:
                yield self._to_places(host, copies)
        finally:
            host_batches.close()
            if copies is not None:
                copies.drain()

    # ---------------- iteration ----------------
    def _iter_sync(self):
        if self._iterable:
            for batch in _batches_from(self.dataset, self.batch_size,
                                       self.drop_last):
                yield self._host(self.collate_fn(batch))
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self._host(self.collate_fn([self.dataset[i]]))
            return
        for indices in self.batch_sampler:
            yield self._fetch(indices)

    def _iter_threaded(self):
        """Worker threads fetch and collate; ``num_workers *
        prefetch_factor`` batches in flight, delivered in sampler
        order."""
        index_iter = iter(self.batch_sampler)
        max_inflight = self.num_workers * self.prefetch_factor
        results = {}
        results_lock = threading.Condition()
        task_q = queue.Queue()
        n_submitted = 0
        n_consumed = 0
        done_submitting = False

        def worker(wid):
            _worker_tls.info = WorkerInfo(wid, self.num_workers,
                                          self.dataset)
            init_err = None
            if self.worker_init_fn is not None:
                try:
                    self.worker_init_fn(wid)
                except Exception as e:  # noqa: BLE001 — surface, don't die
                    init_err = e
            while True:
                item = task_q.get()
                if item is None:
                    return
                seq, indices = item
                if init_err is not None:
                    out = init_err
                else:
                    try:
                        out = self._fetch(indices)
                    except Exception as e:  # noqa: BLE001 — to the consumer
                        out = e
                with results_lock:
                    results[seq] = out
                    results_lock.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(max_inflight):
                try:
                    task_q.put((n_submitted, next(index_iter)))
                    n_submitted += 1
                except StopIteration:
                    done_submitting = True
                    break
            while n_consumed < n_submitted or not done_submitting:
                stall_t0 = time.perf_counter()
                with results_lock:
                    while n_consumed not in results:
                        got = results_lock.wait(timeout=self.timeout or None)
                        # the batch may land just as the deadline passes
                        if not got and self.timeout \
                                and n_consumed not in results:
                            raise RuntimeError(
                                f"DataLoader worker timed out after "
                                f"{self.timeout}s waiting for batch "
                                f"{n_consumed}")
                    out = results.pop(n_consumed)
                    depth = len(results)
                _note_delivery(time.perf_counter() - stall_t0, depth,
                               "threads", n_consumed)
                n_consumed += 1
                if isinstance(out, Exception):
                    raise out
                if not done_submitting:
                    try:
                        task_q.put((n_submitted, next(index_iter)))
                        n_submitted += 1
                    except StopIteration:
                        done_submitting = True
                yield out
        finally:
            for _ in threads:
                task_q.put(None)

    def _iter_process(self):
        """Spawned process workers fetch and collate to NumPy; the parent
        delivers in sampler order."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        procs = [
            ctx.Process(
                target=_process_worker,
                args=(self.dataset, self._proc_collate, self.worker_init_fn,
                      wid, self.num_workers, task_q, result_q),
                daemon=True)
            for wid in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        index_iter = iter(self.batch_sampler)
        max_inflight = self.num_workers * self.prefetch_factor
        results = {}
        n_submitted = 0
        n_consumed = 0
        done_submitting = False
        try:
            for _ in range(max_inflight):
                try:
                    task_q.put((n_submitted, list(next(index_iter))))
                    n_submitted += 1
                except StopIteration:
                    done_submitting = True
                    break
            while n_consumed < n_submitted or not done_submitting:
                waited = 0.0
                stall_t0 = time.perf_counter()
                while n_consumed not in results:
                    # short polls, so a dead worker raises instead of
                    # blocking forever
                    try:
                        seq, out = result_q.get(timeout=1.0)
                        results[seq] = out
                        continue
                    except queue.Empty:
                        waited += 1.0
                    if not all(p.is_alive() for p in procs):
                        raise RuntimeError(
                            "DataLoader process worker died unexpectedly "
                            f"while batch {n_consumed} was in flight")
                    if self.timeout and waited >= self.timeout:
                        raise RuntimeError(
                            f"DataLoader process worker timed out after "
                            f"{self.timeout}s waiting for batch {n_consumed}")
                out = results.pop(n_consumed)
                _note_delivery(time.perf_counter() - stall_t0, len(results),
                               "procs", n_consumed)
                n_consumed += 1
                if isinstance(out, Exception):
                    raise out
                if not done_submitting:
                    try:
                        task_q.put((n_submitted, list(next(index_iter))))
                        n_submitted += 1
                    except StopIteration:
                        done_submitting = True
                yield self._host(out)
        finally:
            for _ in procs:
                task_q.put(None)
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()

    def _iter_threaded_iterable(self):
        """Each worker thread iterates its own shallow copy of the
        dataset with its WorkerInfo installed (the dataset shards itself;
        an unsharded one is replicated ``num_workers`` times, as in the
        reference); batches arrive in completion order."""
        out_q = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        stop = threading.Event()

        def _put(item):
            # a bounded put that gives up once the consumer is gone
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(wid):
            try:
                ds = copy.copy(self.dataset)
            except Exception:  # noqa: BLE001 — an uncopyable one is shared
                ds = self.dataset
            _worker_tls.info = WorkerInfo(wid, self.num_workers, ds)
            try:
                if self.worker_init_fn is not None:
                    self.worker_init_fn(wid)
                for batch in _batches_from(ds, self.batch_size,
                                           self.drop_last):
                    if not _put(("b", self._host(self.collate_fn(batch)))):
                        return
            except Exception as e:  # noqa: BLE001
                _put(("e", e))
            finally:
                _put(("done", wid))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        live = self.num_workers
        waited = 0.0
        try:
            while live:
                try:
                    kind, payload = out_q.get(timeout=1.0)
                    waited = 0.0
                except queue.Empty:
                    waited += 1.0
                    if self.timeout and waited >= self.timeout:
                        raise RuntimeError(
                            f"DataLoader worker timed out after "
                            f"{self.timeout}s")
                    continue
                if kind == "done":
                    live -= 1
                elif kind == "e":
                    raise payload
                else:
                    yield payload
        finally:
            # early exit: unblock queue-blocked workers, then wait briefly;
            # a thread stuck in the dataset's own code cannot be
            # interrupted and is left as a daemon (it gives up its next
            # put once stop is set)
            stop.set()
            t0 = time.monotonic()
            for t in threads:
                while t.is_alive() and time.monotonic() - t0 < 2.0:
                    try:
                        out_q.get_nowait()
                    except queue.Empty:
                        pass
                    t.join(timeout=0.1)

    def _iter_process_iterable(self):
        """Each spawned child iterates its own replica of the dataset and
        ships collated NumPy batches through a bounded queue."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        result_q = ctx.Queue(maxsize=self.num_workers * self.prefetch_factor
                             + self.num_workers)
        procs = [
            ctx.Process(
                target=_process_worker_iterable,
                args=(self.dataset, self._proc_collate, self.worker_init_fn,
                      wid, self.num_workers, self.batch_size, self.drop_last,
                      result_q),
                daemon=True)
            for wid in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        done = set()
        waited = 0.0
        dead_polls = 0
        try:
            while len(done) < self.num_workers:
                try:
                    kind, payload = result_q.get(timeout=1.0)
                    waited = 0.0
                    dead_polls = 0
                except queue.Empty:
                    waited += 1.0
                    # a worker gone without its "done" died; a clean exit
                    # (code 0) may still have batches in the feeder pipe,
                    # so it counts as dead only after several empty polls
                    dead = [i for i, p in enumerate(procs)
                            if i not in done and not p.is_alive()]
                    crashed = [i for i in dead if procs[i].exitcode]
                    if crashed and result_q.empty():
                        raise RuntimeError(
                            f"DataLoader process worker {crashed[0]} died "
                            "unexpectedly "
                            f"(exitcode {procs[crashed[0]].exitcode})")
                    dead_polls = dead_polls + 1 if dead else 0
                    if dead and dead_polls >= 3 and result_q.empty():
                        raise RuntimeError(
                            f"DataLoader process worker {dead[0]} died "
                            "unexpectedly")
                    if self.timeout and waited >= self.timeout:
                        raise RuntimeError(
                            f"DataLoader process worker timed out after "
                            f"{self.timeout}s")
                    continue
                if kind == "done":
                    done.add(payload)
                elif kind == "e":
                    raise payload
                else:
                    yield self._host(payload)
        finally:
            # children may be blocked on the bounded queue: terminate
            # rather than strand them
            for p in procs:
                p.join(timeout=0.2)
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
