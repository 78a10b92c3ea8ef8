"""Device-memory ledger (the port's copy of the ledger half of
``paddle_tpu/observability/memory.py``).

:class:`MemoryLedger` holds one byte-accounting callable per named
component (the engine registers its paged KV pool, its weights and its
device-resident decode state) and reconciles their sum against what
the caching allocator reports live on the card
(``torch.cuda.memory_allocated``).  ``snapshot()`` publishes the result
as ``memory.*`` gauges under the JAX package's names:

* ``memory.accounted_bytes{ledger,component}`` — each component's own
  claim;
* ``memory.accounted_total_bytes`` / ``memory.live_bytes`` — the two
  sides of the reconciliation;
* ``memory.unaccounted_bytes`` — live minus accounted (rotary tables,
  the allocator's scratch, anything nobody claims);
* ``memory.leak_delta_bytes`` — growth of the unaccounted residue since
  the baseline mark: bytes NOBODY accounts for growing monotonically is
  the leak signature;
* ``memory.host_arena_bytes{ledger,component}`` — host components (the
  tiered-KV spill arena), reported beside the device reconciliation and
  summed into none of it.

Torch keeps no count of live CPU tensors, so on the CPU
:func:`live_device_bytes` is 0 (tests patch it).

:func:`host_device_bandwidth_gbs` is the number the host KV tier's
``auto`` swap policy divides upload bytes by: on a CUDA device a
one-shot pinned host→device copy timed with CUDA events, on the CPU a
memcpy probe.  Both are memoized per process.  There is no datasheet
table.  Not ported: ``publish_roofline`` and ``backend_bandwidth_gbs``,
which need program cards.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from . import metrics as _metrics

_ACCT = _metrics.gauge(
    "memory.accounted_bytes",
    "device bytes each registered component claims to hold")
_ACCT_TOTAL = _metrics.gauge(
    "memory.accounted_total_bytes",
    "sum of all component-accounted device bytes")
_LIVE = _metrics.gauge(
    "memory.live_bytes",
    "bytes the CUDA caching allocator holds in live tensors at the last "
    "reconcile")
_UNACCT = _metrics.gauge(
    "memory.unaccounted_bytes",
    "live bytes no registered component accounts for")
_LEAK = _metrics.gauge(
    "memory.leak_delta_bytes",
    "growth of the unaccounted residue since the baseline mark")
_HOST_ACCT = _metrics.gauge(
    "memory.host_arena_bytes",
    "pinned host-RAM bytes each registered host component holds (the "
    "tiered-KV spill arena); deliberately OUTSIDE the device "
    "reconciliation, which counts device allocations only")

_BW_PROBED = {}
_BW_LOCK = threading.Lock()
#: bytes of the card's host->device probe copy
_PROBE_BYTES = 256 << 20


def host_device_bandwidth_gbs(device):
    """Host->device transfer bandwidth in GB/s for ``device`` (a
    ``torch.device`` or its string): what a tiered-KV swap's upload
    seconds divide by.  On a CUDA device, the best of 4 timed copies of
    a 256 MiB pinned host buffer into device memory (CUDA events); on
    the CPU a host->device "transfer" is a memcpy, so a 64 MiB memcpy
    probe (read + write counted, best of 4) is the honest figure.  Runs
    once per device and process."""
    device = torch.device(device)
    key = (device.type, device.index)
    with _BW_LOCK:
        if key not in _BW_PROBED:
            _BW_PROBED[key] = (_cuda_probe_gbs(device)
                               if device.type == "cuda"
                               else _memcpy_probe_gbs())
        return _BW_PROBED[key]


def _cuda_probe_gbs(device):
    src = torch.ones(_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(_PROBE_BYTES, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        dst.copy_(src, non_blocking=True)         # warm the path up
        torch.cuda.synchronize(device)
        best = None
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
            best = dt if best is None else min(best, dt)
    del src, dst
    return _PROBE_BYTES / best / 1e9


def _memcpy_probe_gbs():
    src = np.ones(1 << 26, np.uint8)              # 64 MiB
    dst = np.empty_like(src)
    np.copyto(dst, src)                           # fault pages in
    best = None
    for _ in range(4):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return round(2.0 * src.nbytes / best / 1e9, 1)


def live_device_bytes(device=None):
    """Bytes of live tensors on the CUDA ``device`` (the caching
    allocator's ``memory_allocated``); 0 on the CPU, where torch keeps
    no such count."""
    if device is None or torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(device))


class MemoryLedger:
    """Named byte-accounting components reconciled against
    :func:`live_device_bytes` of ``device``.

    Components are zero-arg callables returning their current device
    bytes; they are polled at ``snapshot()`` time.  The ledger never
    holds tensors itself: callables close over the pools they account,
    and the engine owns the ledger, so its lifetime is the engine's."""

    def __init__(self, name="", device=None):
        self.name = name
        self.device = device
        self._lock = threading.Lock()
        self._components = {}
        self._host_components = {}
        self._baseline_unaccounted = None

    def register(self, component, fn):
        if not callable(fn):
            raise TypeError("component accounting fn must be callable")
        with self._lock:
            self._components[component] = fn
        return self

    def register_host(self, component, fn):
        """Register a HOST-memory component (the pinned tiered-KV spill
        arena).  Host bytes are published as ``memory.host_arena_bytes``
        and reported in the snapshot, but NEVER summed into the device
        reconciliation: the allocator's live count holds no host bytes,
        so counting them as accounted would drive ``unaccounted_bytes``
        negative and break ``leak_delta_bytes``."""
        if not callable(fn):
            raise TypeError("component accounting fn must be callable")
        with self._lock:
            self._host_components[component] = fn
        return self

    def unregister(self, component):
        with self._lock:
            self._components.pop(component, None)

    def components(self):
        with self._lock:
            return list(self._components)

    @staticmethod
    def _poll(items):
        out = {}
        for name, fn in items:
            try:
                out[name] = int(fn())
            except Exception:        # pragma: no cover - defensive
                out[name] = 0
        return out

    def account(self):
        """Poll every component: {component: bytes} (a component that
        raises reports 0 rather than poisoning the snapshot)."""
        with self._lock:
            items = list(self._components.items())
        return self._poll(items)

    def account_host(self):
        """Poll every host component: {component: bytes}."""
        with self._lock:
            items = list(self._host_components.items())
        return self._poll(items)

    def mark_baseline(self):
        """Re-anchor the leak detector at the current residue (called
        automatically by the first snapshot)."""
        acct = self.account()
        self._baseline_unaccounted = (live_device_bytes(self.device)
                                      - sum(acct.values()))
        return self._baseline_unaccounted

    def snapshot(self):
        """Reconcile and publish the ``memory.*`` gauges; returns the
        ledger state as a JSON-able dict."""
        acct = self.account()
        accounted = sum(acct.values())
        live = live_device_bytes(self.device)
        unaccounted = live - accounted
        if self._baseline_unaccounted is None:
            self._baseline_unaccounted = unaccounted
        leak = unaccounted - self._baseline_unaccounted
        labels = dict(ledger=self.name)
        for comp, b in acct.items():
            _ACCT.set(b, component=comp, **labels)
        _ACCT_TOTAL.set(accounted, **labels)
        _LIVE.set(live, **labels)
        _UNACCT.set(unaccounted, **labels)
        _LEAK.set(leak, **labels)
        host = self.account_host()
        for comp, b in host.items():
            _HOST_ACCT.set(b, component=comp, **labels)
        out = {
            "ledger": self.name,
            "components": acct,
            "accounted_total_bytes": accounted,
            "live_bytes": live,
            "unaccounted_bytes": unaccounted,
            "leak_delta_bytes": leak,
        }
        if host:
            # reported alongside, summed into nothing above (see
            # register_host)
            out["host_components"] = host
            out["host_total_bytes"] = sum(host.values())
        return out
