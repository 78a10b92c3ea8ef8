"""Deterministic fault injection for the serving stack (the port's copy
of ``paddle_tpu/serving/faults.py``).

Chaos testing is only useful if a failing run can be replayed exactly —
so nothing in this module is keyed to a wall clock.  A
:class:`FaultPlan` schedules faults by **site-visit ordinals**: "the
3rd time replica0's worker loop reaches its dispatch site, crash it".
The ordinal counters live in the :class:`FaultInjector` and advance
once per visit, so the same plan against the same workload fires the
same faults at the same logical points, every run, and
:meth:`FaultPlan.chaos` derives a whole schedule from a single seed.

Injection sites (each a named point the serving code calls
:meth:`FaultInjector.fire` from):

* ``worker.dispatch`` — the worker loop, immediately before
  ``engine.step()``.  Supports ``crash`` (the worker thread dies, as if
  the process segfaulted), ``exception`` (one dispatch raises and is
  retried — a transient device error), and ``stall`` (the thread
  blocks, as if a collective hung — only the watchdog can notice).
* ``worker.submit`` — the submit/adopt command on the worker thread.
  Supports ``submit_fail`` (a :class:`TransientSubmitError` the
  router's retry/backoff path absorbs).
* ``engine.admit`` — the engine's admission pass.  Supports
  ``pool_exhausted`` (one admission pass behaves as if the KV block
  pool were dry: the batch is deferred to the next horizon boundary).

Every fired fault ticks ``serving.faults_injected{site,kind}`` and
lands in the process event ring, so a chaos run's injected faults
reconcile against the failovers/retries they caused.

The module also owns the fault-adjacent plumbing shared by the router
and gateway: the typed errors (:class:`WorkerCrash`,
:class:`DispatchFault`, :class:`TransientSubmitError`,
:class:`WorkerDeadError`) and :class:`RetryPolicy` — capped exponential
backoff whose jitter is a pure function of ``(seed, ordinal, attempt)``
(blake2b, not ``random``), so retry timing is replayable too.
"""

from __future__ import annotations

import hashlib
import random
import threading
from dataclasses import dataclass, field

from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics

# ------------------------------------------------------------------ kinds
FAULT_CRASH = "crash"                  # worker thread dies
FAULT_EXCEPTION = "exception"          # one dispatch raises, retried
FAULT_STALL = "stall"                  # worker thread hangs (watchdog bait)
FAULT_SUBMIT_FAIL = "submit_fail"      # transient submit failure (retried)
FAULT_POOL_EXHAUSTED = "pool_exhausted"  # one admission pass sees a dry pool

# ------------------------------------------------------------------ sites
SITE_WORKER_DISPATCH = "worker.dispatch"
SITE_WORKER_SUBMIT = "worker.submit"
SITE_ENGINE_ADMIT = "engine.admit"

#: which kinds are meaningful at which site
SITE_KINDS = {
    SITE_WORKER_DISPATCH: (FAULT_CRASH, FAULT_EXCEPTION, FAULT_STALL),
    SITE_WORKER_SUBMIT: (FAULT_SUBMIT_FAIL,),
    SITE_ENGINE_ADMIT: (FAULT_POOL_EXHAUSTED,),
}

# ----------------------------------------------------------------- errors


class InjectedFault(Exception):
    """Base class for raise-style injected faults."""


class WorkerCrash(InjectedFault):
    """Kills the worker thread — the moral equivalent of a replica
    process dying.  Never caught by the worker loop; the thread exits
    and the fleet supervisor fails its in-flight requests over."""


class DispatchFault(InjectedFault):
    """One dispatch failed transiently; the worker loop retries the
    same step on its next iteration."""


class TransientSubmitError(RuntimeError):
    """A submit that would succeed if retried.  Subclasses RuntimeError
    so un-retried paths degrade to the gateway's existing 503 handling
    instead of a 500."""


class WorkerDeadError(RuntimeError):
    """A command was issued to a worker whose engine thread has died
    (crashed or stopped).  Typed so callers can distinguish "replica is
    gone, fail over" from a mere timeout."""


# ---------------------------------------------------------------- metrics
_SRV_FAULTS = _obs_metrics.counter(
    "serving.faults_injected",
    "faults fired by the injection layer, by site and kind")
_SRV_FAILOVERS = _obs_metrics.counter(
    "serving.failovers",
    "in-flight requests re-dispatched to a surviving replica")
_SRV_RETRIES = _obs_metrics.counter(
    "serving.retries",
    "submit attempts retried after a transient failure")
_SRV_DEGRADATION = _obs_metrics.gauge(
    "serving.degradation_level",
    "engine graceful-degradation ladder level "
    "(0 normal, 1 spec off, 2 horizon=1, 3 shedding)")
_SRV_SHED = _obs_metrics.counter(
    "serving.degradation_shed",
    "queued requests shed by the degradation ladder")

#: degradation-ladder level names, indexed by level
DEGRADE_LEVELS = ("normal", "no_spec", "horizon_1", "shed")


# ------------------------------------------------------------------- plan
@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``kind`` at ``site`` on visit ordinals
    ``at .. at+times-1`` (0-based, counted per ``(scope, site)``).
    ``scope`` names the worker/engine the fault targets; ``""`` matches
    any scope."""

    site: str
    kind: str
    at: int
    scope: str = ""
    times: int = 1

    def __post_init__(self):
        if self.site not in SITE_KINDS:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"one of {sorted(SITE_KINDS)}")
        if self.kind not in SITE_KINDS[self.site]:
            raise ValueError(
                f"kind {self.kind!r} not valid at site {self.site!r}; "
                f"one of {SITE_KINDS[self.site]}")
        if self.at < 0 or self.times < 1:
            raise ValueError("need at >= 0 and times >= 1")

    def matches(self, scope, site, ordinal):
        return (self.site == site
                and self.scope in ("", scope)
                and self.at <= ordinal < self.at + self.times)


class FaultPlan:
    """An immutable schedule of :class:`FaultSpec`\\ s.

    The plan is pure data — it never counts anything; pair it with a
    :class:`FaultInjector` (which owns the ordinal counters) to arm it.
    One plan can arm many injectors: each replays identically."""

    def __init__(self, specs=(), seed=0):
        self.specs = tuple(specs)
        self.seed = int(seed)

    def match(self, scope, site, ordinal):
        """First spec firing at this (scope, site, ordinal), or None."""
        for spec in self.specs:
            if spec.matches(scope, site, ordinal):
                return spec
        return None

    @classmethod
    def chaos(cls, seed, scopes, n_faults=6, max_ordinal=24,
              kinds=(FAULT_CRASH, FAULT_STALL, FAULT_EXCEPTION,
                     FAULT_SUBMIT_FAIL, FAULT_POOL_EXHAUSTED)):
        """Derive a whole chaos schedule from one seed: ``n_faults``
        faults of the given kinds spread over the given scopes at
        ordinals in ``[0, max_ordinal)``.  At most one *fatal* fault
        (crash/stall) per scope — a chaos run that kills every replica
        proves nothing about recovery."""
        rng = random.Random(int(seed))
        site_of = {k: s for s, ks in SITE_KINDS.items() for k in ks}
        specs, used, fatal_scopes = [], set(), set()
        attempts = 0
        while len(specs) < int(n_faults) and attempts < 200:
            attempts += 1
            kind = rng.choice(list(kinds))
            scope = rng.choice(list(scopes))
            ordinal = rng.randrange(int(max_ordinal))
            fatal = kind in (FAULT_CRASH, FAULT_STALL)
            if fatal and scope in fatal_scopes:
                continue
            key = (scope, site_of[kind], ordinal)
            if key in used:
                continue
            used.add(key)
            if fatal:
                fatal_scopes.add(scope)
            specs.append(FaultSpec(site_of[kind], kind, ordinal,
                                   scope=scope))
        specs.sort(key=lambda s: (s.scope, s.site, s.at, s.kind))
        return cls(specs, seed=seed)

    def to_json(self):
        return {"seed": self.seed,
                "specs": [vars(s).copy() if not hasattr(s, "__dict__")
                          else dict(site=s.site, kind=s.kind, at=s.at,
                                    scope=s.scope, times=s.times)
                          for s in self.specs]}

    def __repr__(self):
        return f"FaultPlan(seed={self.seed}, specs={list(self.specs)})"


class FaultInjector:
    """Arms a :class:`FaultPlan`: owns the per-``(scope, site)`` visit
    counters and fires matching faults.  Thread-safe — every worker
    thread of a fleet can share one injector (per-scope ordinals keep
    their schedules independent).

    ``fire(site, scope)`` advances the ordinal and, on a match, either
    raises (crash/exception/submit_fail) or returns the spec
    (stall/pool_exhausted — behaviours the *caller* must act out;
    raising "stall" would be a lie).  No match returns None.  Every
    fired fault is appended to :attr:`fired` — the replay record a
    chaos test reconciles against."""

    def __init__(self, plan):
        if isinstance(plan, (list, tuple)):
            plan = FaultPlan(plan)
        self.plan = plan
        self._lock = threading.Lock()
        self._ordinals = {}            # (scope, site) -> visits so far
        self.fired = []                # (scope, site, kind, ordinal)

    def fire(self, site, scope=""):
        with self._lock:
            n = self._ordinals.get((scope, site), 0)
            self._ordinals[(scope, site)] = n + 1
            spec = self.plan.match(scope, site, n)
            if spec is None:
                return None
            self.fired.append((scope, site, spec.kind, n))
        _SRV_FAULTS.inc(site=site, kind=spec.kind)
        _obs_events.instant("serving.fault_injected", cat="serving",
                            site=site, kind=spec.kind, scope=scope,
                            ordinal=n)
        if spec.kind == FAULT_CRASH:
            raise WorkerCrash(
                f"injected crash at {scope or '?'}:{site} ordinal {n}")
        if spec.kind == FAULT_EXCEPTION:
            raise DispatchFault(
                f"injected dispatch fault at {scope or '?'}:{site} "
                f"ordinal {n}")
        if spec.kind == FAULT_SUBMIT_FAIL:
            raise TransientSubmitError(
                f"injected transient submit failure at "
                f"{scope or '?'}:{site} ordinal {n}")
        return spec                    # stall / pool_exhausted

    def counts(self):
        """Fired-fault totals by kind (the reconciliation view)."""
        out = {}
        with self._lock:
            for _, _, kind, _ in self.fired:
                out[kind] = out.get(kind, 0) + 1
        return out


# ------------------------------------------------------------------ retry
def _jitter_fraction(seed, ordinal, attempt):
    """Deterministic jitter in [0, 1): a pure blake2b hash of
    (seed, ordinal, attempt) — two gateways with the same seed retry
    with the same delays, and a replayed chaos run sleeps identically."""
    h = hashlib.blake2b(f"{seed}|{ordinal}|{attempt}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


@dataclass
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    ``delay(ordinal, attempt)`` is the sleep before retry ``attempt``
    (0-based) of request ``ordinal``: ``min(cap, base * 2**attempt)``
    scaled into ``[0.5, 1.0)`` of itself by the jitter hash — full
    determinism, yet no two requests' retries synchronize into a
    thundering herd.  ``max_retries`` is the per-request budget; only
    after it is spent may the caller surface a 503, with
    ``delay(ordinal, attempt+1)`` as the honest Retry-After."""

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    seed: int = 0

    def delay(self, ordinal, attempt):
        base = min(float(self.backoff_cap_s),
                   float(self.backoff_base_s) * (2.0 ** int(attempt)))
        return base * (0.5 + 0.5 * _jitter_fraction(self.seed, ordinal,
                                                    attempt))
