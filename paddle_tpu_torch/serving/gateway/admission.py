"""Gateway admission layer: per-tenant token-bucket quotas and
load-shedding decisions (the port's copy of
``paddle_tpu/serving/gateway/admission.py``).

The gateway admits a request through two independent gates before any
engine sees it:

* **Quota** — every tenant owns a token bucket; a request costs
  ``prompt_tokens + max_tokens`` (the engine bills the same unit in its
  per-tenant ``stats()['tenants']`` accounting, so the quota currency
  and the usage ledger agree).  An empty bucket is a **429** with a
  ``Retry-After`` telling the client exactly when the bucket will hold
  enough tokens again.
* **SLO shed** — the router exposes per-replica health derived from
  each engine's :class:`~paddle_tpu_torch.observability.slo.SLOTracker` (the
  very signal ``/readyz`` flips on).  When NO replica is healthy the
  gateway sheds with **503 + Retry-After** instead of queueing more
  work onto a fleet that is already burning its error budget.

Everything here is pure host-side bookkeeping with an injectable clock
(``clock=...``), so the refill math is exactly testable without
sleeping.
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """A classic token bucket: ``capacity`` tokens, refilled at
    ``refill_per_s`` tokens per second, lazily on access (no timer
    thread).  ``try_take(n)`` either debits ``n`` and grants, or
    denies with the seconds until the bucket will hold ``n`` again.

    Thread-safe: gateway handler threads race on the same tenant's
    bucket."""

    def __init__(self, capacity, refill_per_s, clock=time.monotonic):
        if not capacity > 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        if not refill_per_s > 0:
            raise ValueError(
                f"refill_per_s must be > 0, got {refill_per_s}")
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._tokens = float(capacity)
        self._last = clock()
        self._lock = threading.Lock()

    def _refill(self):
        now = self._clock()
        self._tokens = min(self.capacity,
                           self._tokens
                           + (now - self._last) * self.refill_per_s)
        self._last = now

    @property
    def available(self):
        with self._lock:
            self._refill()
            return self._tokens

    def try_take(self, n):
        """Attempt to debit ``n`` tokens.  Returns ``(granted,
        retry_after_s)``: ``(True, 0.0)`` on success, ``(False, s)``
        where ``s`` is the time until ``min(n, capacity)`` tokens will
        be available (a request larger than the whole bucket can never
        be granted; the retry hint then points at a full bucket)."""
        n = float(n)
        with self._lock:
            self._refill()
            if n <= self._tokens:
                self._tokens -= n
                return True, 0.0
            need = min(n, self.capacity) - self._tokens
            return False, need / self.refill_per_s


class TenantQuotas:
    """Per-tenant token buckets under one default quota, with optional
    per-tenant overrides (:meth:`set_quota`).  With ``capacity=None``
    quota enforcement is off and every request is granted — the
    gateway's default, so a bare ``Gateway(engines)`` never 429s.

    Buckets are created lazily on a tenant's first request; the empty
    string is the bucket anonymous requests (no ``tenant``/``user``
    field) bill against, matching the engine's accounting key."""

    def __init__(self, capacity=None, refill_per_s=None,
                 clock=time.monotonic):
        if capacity is not None and refill_per_s is None:
            # sensible default: a full bucket refills in one second
            refill_per_s = capacity
        self._capacity = capacity
        self._refill = refill_per_s
        self._clock = clock
        self._buckets = {}
        self._overrides = {}
        self._lock = threading.Lock()

    @property
    def enforcing(self):
        return self._capacity is not None or bool(self._overrides)

    def set_quota(self, tenant, capacity, refill_per_s=None):
        """Give ``tenant`` its own bucket (replacing any existing one,
        full)."""
        with self._lock:
            self._overrides[tenant] = (capacity,
                                       refill_per_s or capacity)
            self._buckets.pop(tenant, None)

    def _bucket(self, tenant):
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                cap, refill = self._overrides.get(
                    tenant, (self._capacity, self._refill))
                if cap is None:
                    return None
                b = TokenBucket(cap, refill, clock=self._clock)
                self._buckets[tenant] = b
            return b

    def admit(self, tenant, cost):
        """Charge ``cost`` tokens to ``tenant``; returns ``(granted,
        retry_after_s)``.  Unquota'd tenants are always granted."""
        bucket = self._bucket(tenant)
        if bucket is None:
            return True, 0.0
        return bucket.try_take(cost)
