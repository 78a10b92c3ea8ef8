"""Gateway router layer: N in-process engine replicas behind one front
door, with prefix-affinity session routing and mid-stream failover (the
port's copy of ``paddle_tpu/serving/gateway/router.py``).

Three pieces:

* :class:`EngineWorker` — the ownership boundary between the threaded
  HTTP layer and a (single-threaded) :class:`~..engine.Engine`.  One
  daemon thread per replica owns every ``submit()/step()/abort()`` on
  its engine; other threads talk to it through a command inbox and get
  a :class:`StreamHandle` back.  After every ``step()`` the worker
  flushes each tracked request's newly harvested tokens into its
  handle's queue — that per-horizon flush is exactly the granularity
  SSE chunks stream at, and since the engine's sampling is a pure
  function of ``(seed, token index, logits)`` and a row's logits do not
  depend on the rows batched beside it, the streamed token sequence is
  bitwise what in-process ``Engine.run()`` produces.
* :class:`PrefixAffinityRouter` — picks a replica per request.  The
  affinity key is the prompt's leading **prefix-cache blocks**, chunked
  exactly the way the radix cache keys its trie
  (``tuple(tokens[:k * block_size])`` — see ``PrefixCache._walk``), so
  two prompts sharing a system prompt share a key and land on the same
  replica, where the radix store already holds those blocks.  Keys map
  to replicas by rendezvous (highest-random-weight) hashing — stable
  under replica add/remove — over the **healthy** replica set only:
  per-replica health is the engine's SLO signal (the same one
  ``/readyz`` serves), so a replica burning its error budget stops
  receiving new sessions until it recovers.  Prompts shorter than one
  block have no affinity key and fall back to the least-loaded healthy
  replica (queue depth + active slots from the engine's scheduler).

* :class:`FleetSupervisor` — the watchdog + failover loop.  Each
  worker's heartbeat ticks once per loop iteration; a worker whose
  thread has died, or that holds work but hasn't heartbeat within
  ``watchdog_timeout_s`` (a hung dispatch — e.g. a wedged collective),
  is **condemned**: its in-flight requests are aborted on the dead
  engine (accounting closure), its ``serving.*`` provider is
  unregistered via ``Engine.close()``, and every stream it held is
  re-dispatched to a surviving replica carrying ``prompt + tokens
  already flushed``.  The adopting engine re-prefills that history
  through the preemption-resume path — whose consistency check
  *asserts* the re-sampled boundary token equals the last one the
  client saw — so, because sampling is a pure function of ``(seed,
  token index, logits)`` and replicas over one model compute the same
  rows, the failed-over stream is byte-identical to an uninterrupted
  run with zero duplicated and zero dropped tokens.

Graceful replica removal composes the pieces: ``router.remove(worker)``
stops routing to it, the worker finishes its in-flight work, and
``Engine.drain()`` releases every pool block (asserting the block-leak
invariant) before the engine is closed.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time

from ...observability import events as _obs_events
from ...observability import tracing as _obs_tracing
from ..faults import (FAULT_STALL, SITE_WORKER_DISPATCH,
                      SITE_WORKER_SUBMIT, _SRV_FAILOVERS, _SRV_RETRIES,
                      DispatchFault, RetryPolicy, TransientSubmitError,
                      WorkerCrash, WorkerDeadError)
from ..scheduler import (FINISH_ABORT, FINISH_EOS, FINISH_LENGTH,
                         FINISHED)


class StreamHandle:
    """The caller-side view of one request running on a worker thread.

    ``events`` is a queue of ``("tokens", [ids])`` chunks — one per
    decode horizon the request rode — terminated by exactly one
    ``("finish", finish_reason)``.  ``request`` is the live engine
    Request (its ``output_ids``/``finish_reason`` fill in as the worker
    steps); treat it as read-only from other threads.

    Under failover the handle is the stable identity the client keeps
    while ``request``/``worker`` are rebound to the adopting replica —
    ``lock`` guards that swap, and ``abort()`` routes a cancellation to
    whichever replica currently holds the request (or, mid-swap, flags
    ``abort_requested`` so the supervisor cancels the pending
    re-dispatch instead)."""

    def __init__(self, request, worker):
        self.request = request
        self.worker = worker
        self.events = queue.Queue()
        #: tokens already flushed into ``events``
        self.sent = 0
        #: guards request/worker rebinding during failover
        self.lock = threading.Lock()
        #: True between condemnation and adoption by a new replica
        self.failing_over = False
        #: client abort seen while failing over (cancels the re-dispatch)
        self.abort_requested = False
        #: completed replica swaps this stream survived
        self.failovers = 0

    @property
    def request_id(self):
        return self.request.request_id

    def abort(self, cause="client_disconnect"):
        """Abort this stream wherever it currently lives.  Safe during
        failover: if the request is between replicas the pending
        re-dispatch is cancelled; otherwise the abort lands on the
        worker that holds the request *now* (fire-and-forget — the
        handle still receives its terminal ``("finish", "abort")``)."""
        with self.lock:
            if self.failing_over:
                self.abort_requested = True
                return
            worker = self.worker
        worker._inbox.put(("abort", self, cause, None))


class EngineWorker:
    """Drives one Engine on a dedicated daemon thread.

    All engine mutation happens on that thread: ``submit()``/
    ``abort()``/``drain()`` enqueue commands and block on a reply, the
    loop applies them between horizon dispatches, steps while work
    exists, and flushes per-request token deltas after every step.
    Reads exposed to other threads (``load``, ``healthy``, ``stats()``)
    are GIL-atomic snapshots of host-side counters.

    The worker is engine-shape agnostic: any object with the Engine
    duck type below drives the same loop.

    Nothing here reads a device tensor from another thread: ``load``,
    ``healthy`` and ``stats()`` read the engine's host mirrors and
    counters only, so HTTP threads never touch the CUDA stream the
    worker thread drives."""

    #: the Engine duck type the worker loop actually exercises
    _ENGINE_API = ("submit", "abort", "step", "drain", "stats", "close")

    def __init__(self, engine, name=None, faults=None,
                 watchdog_timeout_s=None):
        missing = [a for a in self._ENGINE_API
                   if not callable(getattr(engine, a, None))]
        if not hasattr(engine, "scheduler"):
            missing.append("scheduler")
        if missing:
            raise TypeError(
                f"EngineWorker needs an Engine-shaped object; "
                f"{type(engine).__name__} lacks {missing}")
        self.engine = engine
        self.name = name or engine._profiler_name
        self._inbox = queue.Queue()
        self._pending = {}           # request_id -> StreamHandle
        self._draining = False
        self._drained = threading.Event()
        self._stopped = False
        #: fault-injection hook (FaultInjector or None); shared per-fleet
        self._faults = faults
        #: heartbeat staleness past this (while holding work) = stalled;
        #: None disables the local check (the supervisor may set its own)
        self.watchdog_timeout_s = watchdog_timeout_s
        self._heartbeat = time.monotonic()
        #: set by the supervisor: no longer part of the fleet
        self._condemned = False
        #: the engine thread died on an exception (vs clean stop)
        self._crashed = False
        self._crash_error = None
        self._dispatch_faults = 0    # transient dispatch errors retried
        self._unstall = threading.Event()  # test valve: release a stall
        self._thread = threading.Thread(
            target=self._loop, name=f"gateway.worker:{self.name}",
            daemon=True)
        self._thread.start()

    def set_faults(self, injector):
        """Arm (or disarm, with None) fault injection on this worker
        AND its engine's admission site."""
        self._faults = injector
        if hasattr(self.engine, "install_faults"):
            self.engine.install_faults(injector, scope=self.name)

    # ------------------------------------------------------------- control
    def submit(self, prompt_ids, sampling=None, priority=0,
               deadline_s=None, tenant=None, grammar=None,
               trace_args=None, timeout=30.0):
        """Submit on the worker thread; returns a :class:`StreamHandle`.
        ``trace_args`` (tenant/priority/hop_s from the gateway) are
        appended to the flight record as the ``gateway`` event — on the
        engine thread, so event order stays queued -> gateway ->
        prefill.  Raises whatever ``Engine.submit`` raises (validation)
        or RuntimeError when the replica is draining/stopped."""
        if not self.alive:
            raise WorkerDeadError(f"replica {self.name} is stopped")
        reply = queue.Queue(1)
        self._inbox.put(("submit", dict(
            prompt_ids=prompt_ids, sampling=sampling, priority=priority,
            deadline_s=deadline_s, tenant=tenant, grammar=grammar),
            trace_args, reply))
        kind, value = self._await(reply, timeout)
        if kind == "error":
            raise value
        return value

    def adopt(self, handle, prompt_ids, sampling=None, priority=0,
              tenant=None, grammar=None, resume_ids=(),
              from_replica="", reason="", timeout=30.0):
        """Failover adoption: re-submit a condemned replica's in-flight
        request on THIS worker, resuming from ``resume_ids`` (the
        tokens the client has already received).  On the worker thread
        the engine re-prefills ``prompt + resume_ids`` via the resume
        path — whose bitwise consistency check makes the continuation
        provably seamless — then the handle is re-pointed at the new
        request/worker and tracked for flushing (``handle.sent`` is
        already ``len(resume_ids)``, so only NEW tokens stream)."""
        if not self.alive:
            raise WorkerDeadError(f"replica {self.name} is stopped")
        reply = queue.Queue(1)
        self._inbox.put(("adopt", dict(
            prompt_ids=prompt_ids, sampling=sampling, priority=priority,
            tenant=tenant, grammar=grammar,
            resume_ids=list(resume_ids),
            from_replica=from_replica, reason=reason),
            handle, reply))
        kind, value = self._await(reply, timeout)
        if kind == "error":
            raise value
        return value

    def _await(self, reply, timeout):
        """Wait on a command reply, polling thread aliveness so a
        command racing a crash raises :class:`WorkerDeadError` instead
        of blocking until the timeout."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return reply.get(timeout=min(0.1, timeout))
            except queue.Empty:
                if not self._thread.is_alive():
                    raise WorkerDeadError(
                        f"replica {self.name} died while processing a "
                        f"command") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"worker {self.name} command timed out")

    def abort(self, handle, cause="client_disconnect"):
        """Abort a tracked request (fire-and-forget; the handle's queue
        still receives its terminal ``("finish", "abort")``).  Routed
        through the handle so an abort issued against a replica the
        request has already failed away from still lands wherever the
        request lives now."""
        handle.abort(cause)

    def drain(self, timeout=120.0):
        """Stop accepting submissions, let in-flight AND queued requests
        run to completion, then ``Engine.drain()`` (releases every pool
        block, asserts the block-leak invariant).  Blocks until done.
        Idempotent; the worker stays alive (for ``stats()``) until
        ``stop()``.  Raises :class:`WorkerDeadError` (not a hang) when
        the engine thread has died — a dead replica cannot drain; its
        streams are the supervisor's to fail over."""
        if not self._thread.is_alive():
            raise WorkerDeadError(
                f"replica {self.name} is dead; cannot drain")
        self._inbox.put(("drain", None, None, None))
        deadline = time.monotonic() + timeout
        while not self._drained.wait(min(0.1, timeout)):
            if not self._thread.is_alive():
                raise WorkerDeadError(
                    f"replica {self.name} died while draining")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"worker {self.name} drain timed out")

    def stop(self, timeout=30.0):
        """Stop the driving thread (does NOT close the engine — the
        owner does, after ``drain()``).  A no-op on a worker whose
        thread already died: there is nothing left to stop, and
        enqueueing to a dead inbox would block callers forever."""
        if self._stopped:
            return
        if not self._thread.is_alive():
            self._stopped = True
            return
        self._inbox.put(("stop", None, None, None))
        self._thread.join(timeout)
        self._stopped = True

    def take_pending(self):
        """Atomically claim every tracked stream (supervisor-only; call
        after condemning the worker, when its thread is dead or blocked
        in an injected stall and can no longer touch ``_pending``).
        Each handle is flagged ``failing_over`` so client aborts racing
        the swap queue behind the re-dispatch decision."""
        pending, self._pending = dict(self._pending), {}
        for h in pending.values():
            with h.lock:
                h.failing_over = True
        return pending

    # -------------------------------------------------------------- health
    @property
    def alive(self):
        return self._thread.is_alive() and not self._stopped

    @property
    def draining(self):
        return self._draining

    @property
    def crashed(self):
        return self._crashed

    @property
    def condemned(self):
        return self._condemned

    @property
    def heartbeat_age_s(self):
        """Seconds since the worker loop last completed an iteration."""
        return time.monotonic() - self._heartbeat

    @property
    def stalled(self):
        """True when the worker holds work but its loop hasn't
        heartbeat within ``watchdog_timeout_s`` — a hung dispatch.  An
        idle worker is never stalled (its heartbeat ticks on every inbox
        poll); ``None`` timeout disables the check."""
        t = self.watchdog_timeout_s
        if t is None or not self._thread.is_alive():
            return False
        return (self.engine.scheduler.has_work
                and self.heartbeat_age_s > float(t))

    @property
    def healthy(self):
        """Routable: thread alive, not draining/condemned/stalled, and
        the engine's SLO tracker (if any) reports healthy — the same
        signal the telemetry server's ``/readyz`` flips on."""
        if (not self.alive or self._draining or self._condemned
                or self.stalled):
            return False
        slo = self.engine.slo
        return slo is None or slo.healthy

    @property
    def load(self):
        """Instantaneous load for least-loaded routing: queued +
        running requests."""
        return (self.engine.scheduler.queue_depth
                + len(self.engine.scheduler.running))

    @property
    def prefix_block_size(self):
        return self.engine._block_size

    def stats(self):
        """The engine's ``stats()`` snapshot plus worker state.  Host
        counters only — safe to call from any thread."""
        s = self.engine.stats()
        s["worker"] = {"name": self.name, "alive": self.alive,
                       "draining": self._draining,
                       "healthy": self.healthy, "load": self.load,
                       "streams": len(self._pending),
                       "crashed": self._crashed,
                       "condemned": self._condemned,
                       "heartbeat_age_s": round(self.heartbeat_age_s, 4),
                       "dispatch_faults": self._dispatch_faults}
        return s

    # ---------------------------------------------------------- the thread
    def _loop(self):
        try:
            self._loop_body()
        except BaseException as e:
            # the thread dies here — injected WorkerCrash, condemnation,
            # or a real engine fault.  Record, close the engine's books
            # (this thread OWNS the engine; the supervisor never touches
            # it), and exit; the supervisor notices (alive flips False)
            # and fails the in-flight streams over.
            self._crashed = True
            self._crash_error = e
            _obs_events.instant("serving.worker_crash", cat="serving",
                                worker=self.name, error=repr(e))
            self._reap_engine()

    def _reap_engine(self):
        """Accounting closure on the way out of a crash: abort every
        request still live on this engine (their traces end in
        ``abort(cause="failover")`` — the supervisor re-dispatches the
        streams from the flushed tokens, not from this engine's state)
        and ``close()`` it, unregistering its ``serving.*`` provider.
        Best-effort: a broken engine may refuse individual aborts."""
        eng = self.engine
        live = list(eng.scheduler.running.values()) + list(
            eng.scheduler.queue)
        for req in live:
            if req.status != FINISHED:
                try:
                    eng.abort(req, cause="failover")
                except Exception:
                    pass
        # the aborts returned every lease, so the radix store's chains
        # are unpinned: reclaim them too, so a dead replica's books
        # read kv_blocks_in_use == 0 instead of a stale nonzero
        try:
            eng.prefix.reclaim(eng.prefix._held)
        except Exception:
            pass
        try:
            eng.close()
        except Exception:
            pass

    def _loop_body(self):
        while True:
            if self._condemned:
                # condemned mid-flight (e.g. a watchdog false positive
                # on a slow first launch, or a real hang that eventually
                # returned): the supervisor already claimed our streams,
                # so die like a crash — _loop reaps the engine
                raise WorkerCrash(f"worker {self.name} condemned")
            busy = self.engine.scheduler.has_work
            try:
                cmd = (self._inbox.get_nowait() if busy
                       else self._inbox.get(timeout=0.05))
            except queue.Empty:
                cmd = None
            if cmd is not None and self._apply(cmd):
                return
            # apply everything already queued before paying for a step
            while True:
                try:
                    cmd = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if self._apply(cmd):
                    return
            if self.engine.scheduler.has_work:
                try:
                    if self._faults is not None:
                        spec = self._faults.fire(SITE_WORKER_DISPATCH,
                                                 scope=self.name)
                        if (spec is not None
                                and spec.kind == FAULT_STALL):
                            self._stall()
                    self.engine.step()
                except DispatchFault:
                    # transient device error: the same step retries on
                    # the next iteration — requests see one late horizon
                    self._dispatch_faults += 1
                else:
                    if self._flush():
                        # yield the GIL before the next dispatch so
                        # handler threads woken by the flush get to
                        # write their SSE frames now, not a
                        # switch-interval (~5 ms) later
                        time.sleep(0)
            elif self._draining and not self._drained.is_set():
                self.engine.drain()      # queue empty: releases blocks
                self._drained.set()
            self._heartbeat = time.monotonic()

    def _stall(self):
        """Act out an injected stall: block (heartbeat frozen) until
        the supervisor condemns this worker — then die like a crash,
        having never touched ``_pending`` again — or a test releases
        the valve (``_unstall``)."""
        while not self._condemned and not self._unstall.is_set():
            time.sleep(0.002)
        if self._condemned:
            raise WorkerCrash(
                f"worker {self.name} condemned while stalled")
        self._unstall.clear()

    def _apply(self, cmd):
        """Execute one command on the engine thread; True = stop."""
        self._heartbeat = time.monotonic()
        op, arg, extra, reply = cmd
        if op == "stop":
            return True
        if op == "submit":
            if self._draining:
                reply.put(("error", RuntimeError(
                    f"replica {self.name} is draining")))
                return False
            try:
                if self._faults is not None:
                    self._faults.fire(SITE_WORKER_SUBMIT,
                                      scope=self.name)
                req = self.engine.submit(**arg)
            except Exception as e:
                reply.put(("error", e))
                return False
            if extra and req.trace is not None:
                req.trace.add(_obs_tracing.GATEWAY, **extra)
            handle = StreamHandle(req, self)
            self._pending[req.request_id] = handle
            reply.put(("ok", handle))
        elif op == "adopt":
            handle = extra
            if self._draining:
                reply.put(("error", RuntimeError(
                    f"replica {self.name} is draining")))
                return False
            # the whole adoption is atomic under the handle lock: an
            # adopt the supervisor gave up on (command timeout against
            # a stalled replica) can still be DELIVERED later — by then
            # a retried adopt has cleared ``failing_over``, and this
            # stale one must decline instead of forking the stream
            # onto two engines
            with handle.lock:
                if not handle.failing_over:
                    reply.put(("error", RuntimeError(
                        f"stale adopt on {self.name}: stream "
                        f"{handle.request_id} already re-homed")))
                    return False
                try:
                    if self._faults is not None:
                        self._faults.fire(SITE_WORKER_SUBMIT,
                                          scope=self.name)
                    req = self.engine.submit(
                        arg["prompt_ids"], sampling=arg["sampling"],
                        priority=arg["priority"], tenant=arg["tenant"],
                        grammar=arg.get("grammar"),
                        resume_ids=arg["resume_ids"])
                except Exception as e:
                    reply.put(("error", e))
                    return False
                if req.trace is not None:
                    req.trace.add(_obs_tracing.FAILOVER,
                                  from_replica=arg["from_replica"],
                                  reason=arg["reason"],
                                  resumed_tokens=len(arg["resume_ids"]))
                handle.request = req
                handle.worker = self
                handle.failing_over = False
                handle.failovers += 1
                aborted = handle.abort_requested
            self._pending[req.request_id] = handle
            if aborted:
                # the client hung up while the swap was in flight
                self.engine.abort(req, cause="client_disconnect")
                self._flush()
            reply.put(("ok", handle))
        elif op == "abort":
            handle, cause = arg, extra
            if handle.worker is not self:
                # the request failed away from this replica after the
                # abort was enqueued — re-route through the handle
                handle.abort(cause)
            elif handle.request.status != FINISHED:
                self.engine.abort(handle.request, cause=cause)
                self._flush()
        elif op == "drain":
            self._draining = True
        return False

    def _flush(self):
        """Push each tracked request's newly harvested tokens (and its
        terminal event) into its handle queue — the per-horizon flush
        the SSE stream rides.  Returns True if any event was pushed."""
        done, pushed = [], False
        for rid, h in self._pending.items():
            n = h.request.n_generated
            if n > h.sent:
                h.events.put(("tokens",
                              list(h.request.output_ids[h.sent:n])))
                h.sent = n
                pushed = True
            if h.request.status == FINISHED:
                h.events.put(("finish", h.request.finish_reason))
                done.append(rid)
                pushed = True
        for rid in done:
            del self._pending[rid]
        return pushed


def _rendezvous_weight(key, name):
    """Deterministic highest-random-weight score for (affinity key,
    replica name) — stable across processes (no PYTHONHASHSEED
    dependence), uniform enough that distinct system prompts spread
    over replicas."""
    h = hashlib.blake2b(repr(key).encode() + b"|" + name.encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


class PrefixAffinityRouter:
    """Routes requests over a set of :class:`EngineWorker` replicas.

    ``affinity_blocks`` bounds how many leading prefix-cache blocks key
    the session: hashing MORE blocks than the shared system prompt
    would scatter same-prefix sessions (their suffixes differ), hashing
    fewer costs nothing — so the default is small."""

    def __init__(self, workers, affinity_blocks=2, retry=None):
        if not workers:
            raise ValueError("router needs at least one worker")
        self.workers = list(workers)
        self.affinity_blocks = int(affinity_blocks)
        #: RetryPolicy for transient submit failures (None = no retry)
        self.retry = retry
        self._ordinal_lock = threading.Lock()
        self._submit_ordinal = 0

    def next_ordinal(self):
        """Monotonic submit ordinal — the per-request key the retry
        policy's deterministic jitter hashes on."""
        with self._ordinal_lock:
            n = self._submit_ordinal
            self._submit_ordinal += 1
        return n

    def affinity_key(self, prompt_ids):
        """The routing key: the prompt's leading full blocks, chunked
        with the radix cache's block size (``None`` when the prompt is
        shorter than one block — no reusable prefix to be affine to)."""
        bs = self.workers[0].prefix_block_size
        nb = min(self.affinity_blocks, len(prompt_ids) // bs)
        if nb <= 0:
            return None
        return tuple(int(t) for t in prompt_ids[:nb * bs])

    def route(self, prompt_ids):
        """Pick a replica: ``(worker, how)`` where ``how`` is
        ``"affine"`` (rendezvous hash of the prefix key over healthy
        replicas) or ``"least-loaded"`` (no key).  ``(None, "shed")``
        when no replica is healthy — the gateway's 503 signal."""
        live = [w for w in self.workers if w.healthy]
        if not live:
            return None, "shed"
        key = self.affinity_key(prompt_ids)
        if key is None:
            return min(live, key=lambda w: (w.load, w.name)), \
                "least-loaded"
        return max(live,
                   key=lambda w: _rendezvous_weight(key, w.name)), \
            "affine"

    def submit(self, prompt_ids, sampling=None, **kw):
        """Route + submit in one call; returns ``(handle, worker,
        how)`` or raises RuntimeError when every replica is shedding.
        Transient submit failures are retried under :attr:`retry`
        (capped exponential backoff, deterministic jitter), re-routing
        each attempt — a replica that died between route and submit
        just sends the retry elsewhere.  Only a spent budget
        propagates the error."""
        ordinal = self.next_ordinal()
        attempt = 0
        while True:
            worker, how = self.route(prompt_ids)
            if worker is None:
                raise RuntimeError("no healthy replica")
            try:
                return (worker.submit(prompt_ids, sampling=sampling,
                                      **kw), worker, how)
            except (TransientSubmitError, WorkerDeadError,
                    TimeoutError):
                # TimeoutError: the replica stopped answering its inbox
                # (stalled inside its watchdog leash) — as transient as
                # a dead one from the caller's seat
                if self.retry is None or attempt >= self.retry.max_retries:
                    raise
                _SRV_RETRIES.inc(replica=worker.name)
                time.sleep(self.retry.delay(ordinal, attempt))
                attempt += 1

    def remove(self, worker, close_engine=True):
        """Graceful replica removal: stop routing to it, drain it
        (in-flight work finishes, every pool block released), stop its
        thread, and optionally close its engine."""
        self.workers.remove(worker)
        worker.drain()
        worker.stop()
        if close_engine:
            # ownership transferred: drain() emptied it and stop()
            # joined the worker thread — no live thread can touch it
            worker.engine.close()


class FleetSupervisor:
    """The watchdog + failover loop over a router's workers.

    ``check()`` is one synchronous sweep (what tests drive directly):
    any worker whose thread died, or that is ``stalled`` past
    ``watchdog_timeout_s``, is condemned and its streams failed over.
    ``start()`` runs the sweep on a daemon thread every ``interval_s``
    — what the gateway wires up.

    Condemnation is one-way: the worker is flagged (``healthy`` flips
    False, a blocked stall raises out and the thread dies), and the
    dying thread itself closes its engine's books (in-flight traces
    end in ``abort(cause="failover")``; ``Engine.close()`` unregisters
    its ``serving.*`` telemetry provider — the supervisor never touches
    an engine it doesn't own).  Then each claimed stream is
    re-dispatched: the router
    picks a surviving replica, ``worker.adopt()`` resumes from the
    tokens the client already received, and ``serving.failovers``
    ticks.  A stream whose resume history already terminates (EOS
    sampled / token budget spent — the worker died between harvest and
    flush of the finish) is finished directly instead of re-decoded,
    and a stream whose client hung up mid-swap is dropped — that is
    the cancel path of the pending re-dispatch.

    Failover never reads the condemned engine's state — the new
    replica recomputes from the handle's flushed tokens — so it is
    correct even against a *real* wedged dispatch that keeps host
    state pinned; in that one case the wedged engine's blocks stay
    leaked until process exit, which is what ``condemned`` stats are
    for."""

    def __init__(self, router, watchdog_timeout_s=60.0, interval_s=1.0,
                 retry=None, adopt_timeout_s=10.0):
        self.router = router
        self.watchdog_timeout_s = (None if watchdog_timeout_s is None
                                   else float(watchdog_timeout_s))
        self.interval_s = float(interval_s)
        self.retry = retry or RetryPolicy()
        #: per-attempt adopt command timeout — deliberately shorter
        #: than a worker command timeout, so one stalled-but-not-yet-
        #: condemned adoption target can't wedge the whole sweep
        self.adopt_timeout_s = float(adopt_timeout_s)
        self.failovers = 0           # streams successfully re-dispatched
        self.failover_failures = 0   # streams aborted (no healthy target)
        self.condemned = []          # (worker.name, reason)
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="gateway.supervisor", daemon=True)
        self._thread.start()

    def stop(self, timeout=10.0):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception as e:
                _obs_events.instant("serving.supervisor_error",
                                    cat="serving", error=repr(e))

    # ------------------------------------------------------------- the sweep
    def check(self):
        """One watchdog sweep; returns the workers condemned by it.  A
        worker's own ``watchdog_timeout_s`` (when set) overrides the
        supervisor default — a replica known to run long dispatches can
        carry a longer leash than the fleet."""
        acted = []
        for w in list(self.router.workers):
            if w._condemned or w._stopped:
                continue
            t = w.watchdog_timeout_s
            if t is None:
                t = self.watchdog_timeout_s
            if not w._thread.is_alive():
                self.condemn(w, "crash")
                acted.append(w)
            elif (t is not None and w.engine.scheduler.has_work
                  and w.heartbeat_age_s > float(t)):
                self.condemn(w, "watchdog_stall")
                acted.append(w)
        return acted

    def condemn(self, worker, reason):
        """Remove a dead/hung worker from service and fail its
        in-flight streams over to the survivors."""
        with self._lock:
            if worker._condemned:
                return
            worker._condemned = True
            self.condemned.append((worker.name, reason))
        _obs_events.instant("serving.worker_condemned", cat="serving",
                            worker=worker.name, reason=reason)
        pending = worker.take_pending()
        # NOTE: the supervisor never touches the condemned engine — the
        # worker thread owns it, and tearing it down from here while
        # the thread may still be inside a dispatch corrupts device
        # state.  The thread closes its own books on the way out
        # (``_reap_engine``: in-flight traces end in
        # ``abort(cause="failover")``, ``Engine.close()`` unregisters
        # the serving.* provider); a thread wedged forever in a real
        # hung dispatch leaks its engine until process exit, which is
        # what the ``condemned`` stats are for.
        for h in pending.values():
            self._failover(h, worker, reason)
        return pending

    def _failover(self, handle, from_worker, reason):
        req = handle.request
        sent = int(handle.sent)
        resume = [int(t) for t in req.output_ids[:sent]]
        with handle.lock:
            if handle.abort_requested:
                # client hung up while the replica was dying: cancel
                # the re-dispatch instead of resuming a dead stream
                handle.failing_over = False
                handle.events.put(("finish", FINISH_ABORT))
                return
        # the stream may already be complete from the client's point of
        # view (the worker died after flushing the last token but
        # before the finish event): finish it, don't re-decode
        eos = getattr(req.sampling, "eos_token_id", None)
        if resume and eos is not None and resume[-1] == int(eos):
            self._finish_direct(handle, FINISH_EOS)
            return
        if len(resume) >= req.sampling.max_new_tokens:
            self._finish_direct(handle, FINISH_LENGTH)
            return
        attempt = 0
        ordinal = self.router.next_ordinal()
        while True:
            worker, _how = self.router.route(req.prompt_ids)
            if worker is None:
                self._abort_stream(handle, "failover_no_replica")
                return
            try:
                worker.adopt(handle, prompt_ids=req.prompt_ids,
                             sampling=req.sampling,
                             priority=req.priority, tenant=req.tenant,
                             grammar=req.grammar,
                             resume_ids=resume,
                             from_replica=from_worker.name,
                             reason=reason,
                             timeout=self.adopt_timeout_s)
            except (TransientSubmitError, WorkerDeadError,
                    RuntimeError, TimeoutError):
                # a timed-out adopt may still be delivered later; the
                # worker-side stale-adopt guard declines it, so
                # retrying onto another replica cannot fork the stream
                with handle.lock:
                    if not handle.failing_over:
                        # ... and conversely, a timed-out attempt that
                        # landed anyway re-homed the stream already —
                        # this retry's decline IS that success
                        worker = handle.worker
                        break
                if attempt >= self.retry.max_retries:
                    self._abort_stream(handle, "failover_retry_budget")
                    return
                _SRV_RETRIES.inc(replica=worker.name)
                time.sleep(self.retry.delay(ordinal, attempt))
                attempt += 1
                continue
            break
        with self._lock:
            self.failovers += 1
        _SRV_FAILOVERS.inc(from_replica=from_worker.name,
                           to_replica=worker.name)
        _obs_events.instant("serving.failover", cat="serving",
                            request_id=req.request_id,
                            from_replica=from_worker.name,
                            to_replica=worker.name, reason=reason,
                            resumed_tokens=len(resume))

    def _finish_direct(self, handle, finish_reason):
        with handle.lock:
            handle.failing_over = False
        handle.request.finish_reason = finish_reason
        handle.events.put(("finish", finish_reason))
        with self._lock:
            self.failovers += 1
        _SRV_FAILOVERS.inc(from_replica=handle.worker.name,
                           to_replica="-")

    def _abort_stream(self, handle, why):
        with handle.lock:
            handle.failing_over = False
        handle.events.put(("finish", FINISH_ABORT))
        with self._lock:
            self.failover_failures += 1
        _obs_events.instant("serving.failover_failed", cat="serving",
                            request_id=handle.request.request_id,
                            reason=why)

    def stats(self):
        with self._lock:
            return {"failovers": self.failovers,
                    "failover_failures": self.failover_failures,
                    "condemned": list(self.condemned)}
