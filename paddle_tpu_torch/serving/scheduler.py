"""Continuous-batching scheduler: admission queue + slot lifecycle.

Requests enter a FIFO queue on ``submit()`` and join the running batch
only at decode-step boundaries (the engine admits before each fused
step).  A request holds its slot until it finishes — EOS or max-tokens —
then the slot returns to the free list and the next queued request can
claim it.  All of this is host-side bookkeeping over the static-shape
device state; nothing here retraces anything.

Admission is batch-aware: ``pop_batch()`` returns a group of queued
requests that share one prefill bucket so the engine can prefill them
all in ONE compiled dispatch.  Grouping may admit a later-submitted
same-bucket request ahead of an earlier different-bucket one, but only
inside a bounded **reorder window**: the queue head always anchors the
batch (strict no-head-starvation), and no request is ever overtaken by
more than ``reorder_window`` later-submitted requests in total.

Admission is also priority-aware (the gateway's admission layer):
every request carries an integer ``priority`` (default 0) and the
reorder window generalizes into a per-pair **overtake budget** —
request ``o`` may be admitted ahead of an earlier-submitted request
``s`` only while

    ``s.bypassed < reorder_window * (1 + max(0, o.priority - s.priority))``

so same-priority traffic keeps the original window exactly, a
higher-priority request gets a budget that widens linearly with the
priority gap, and the starvation bound stays hard: with priorities
capped at ``P``, a queued request is overtaken by at most
``reorder_window * (1 + P)`` later-submitted requests before it MUST
anchor the next batch.  A bounded stable promotion pass
(:meth:`Scheduler.promote`) bubbles higher-priority requests toward
the head inside that budget before each ``pop_batch``.

The exception is the **offline batch lane**: a request with
``priority < 0`` opts out of the starvation bound entirely —
interactive traffic (``priority >= 0``) overtakes it WITHOUT bound
(:meth:`Scheduler.overtake_cap` returns infinity against it, and a
skipped batch request never seals the ``pop_batch`` scan).  Batch
requests still run FIFO among themselves, still anchor a batch when
they reach the head of an otherwise-idle queue, and are first in line
for load shedding (:meth:`shed_victims` drops lowest priority first),
so the lane is preemptible capacity filler, not a starvation hazard.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from .sampling import SamplingParams

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"

FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_ABORT = "abort"


@dataclass
class Request:
    """One generation request and its full lifecycle state."""

    request_id: int
    prompt_ids: list
    sampling: SamplingParams
    status: str = WAITING
    slot: int | None = None
    output_ids: list = field(default_factory=list)
    finish_reason: str | None = None
    #: wall time of submit() — the TTFT clock starts HERE, so queue wait
    #: and prefill are both inside a request's time-to-first-token
    submit_time: float = field(default_factory=time.time)
    #: wall time admission claimed a slot (prefill start)
    admit_time: float | None = None
    first_token_time: float | None = None
    #: tokens of this prompt served from the prefix cache (set by the
    #: engine at admission; 0 when the cache is off or missed)
    prefix_hit_tokens: int = 0
    #: how many later-submitted requests were admitted ahead of this one
    #: (bounded by the scheduler's reorder window)
    bypassed: int = 0
    #: True while this request waits for RE-admission after preemption:
    #: it already held a slot and was swapped out, so admitting it ahead
    #: of later-submitted requests restores order rather than overtakes
    #: — pop_batch extends the head-anchor exemption to it (it neither
    #: spends the reorder window nor charges anyone's bypassed counter)
    resumed: bool = False
    #: the request's observability flight record
    #: (observability.tracing.RequestTrace, attached by the engine at
    #: submit when request tracing is on; None otherwise)
    trace: object = None
    #: admission priority (gateway-era field): 0 is baseline; a higher
    #: value widens the overtake budget against lower-priority queued
    #: requests by ``reorder_window * priority_gap`` (see module doc).
    #: Negative = the offline batch lane: interactive traffic passes
    #: it without bound and load shedding drops it first.
    priority: int = 0
    #: seconds after ``submit_time`` by which the request must have been
    #: admitted; the engine aborts still-QUEUED requests whose deadline
    #: expired (``finish_reason="abort"``, counted in
    #: ``serving.requests_aborted``).  None = no deadline.
    deadline_s: float | None = None
    #: the tenant this request bills against (gateway quota key); None
    #: for in-process callers
    tenant: str | None = None
    #: structured generation: the validated GrammarSpec constraining
    #: this request's output (None = free text).  The engine compiles
    #: and installs it at submit; the scheduler only carries it so
    #: admission and failover can see which requests are constrained.
    grammar: object = None

    @property
    def deadline_expired(self):
        """True when a deadline was set and has passed (measured from
        ``submit_time`` on the wall clock, like TTFT)."""
        return (self.deadline_s is not None
                and time.time() - self.submit_time > self.deadline_s)

    @property
    def prompt_len(self):
        return len(self.prompt_ids)

    @property
    def n_generated(self):
        return len(self.output_ids)

    @property
    def remaining_budget(self):
        """Decode steps left before length retirement.  The engine's
        adaptive horizon never exceeds the smallest remaining budget of
        any running request, so a horizon dispatch cannot overrun a
        lane's ``max_new_tokens`` limit."""
        return self.sampling.max_new_tokens - self.n_generated

    @property
    def queue_seconds(self):
        """Seconds spent waiting for a slot (None until admitted)."""
        if self.admit_time is None:
            return None
        return self.admit_time - self.submit_time

    @property
    def ttft(self):
        """Time-to-first-token in seconds, measured submit -> first
        sampled token, so it INCLUDES queue wait and prefill (None until
        the first token)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    def record_token(self, token):
        """Append a sampled token; returns True when the request is done
        (EOS or max_new_tokens reached)."""
        if self.first_token_time is None:
            self.first_token_time = time.time()
        self.output_ids.append(int(token))
        eos = self.sampling.eos_token_id
        if eos is not None and int(token) == int(eos):
            self.finish_reason = FINISH_EOS
            return True
        if self.n_generated >= self.sampling.max_new_tokens:
            self.finish_reason = FINISH_LENGTH
            return True
        return False


class Scheduler:
    """FIFO admission over a fixed slot pool, with bounded-reorder
    co-bucketed batching via :meth:`pop_batch`."""

    def __init__(self, num_slots, reorder_window=8):
        self.num_slots = num_slots
        self.reorder_window = int(reorder_window)
        self.queue = deque()
        self.running = {}           # slot -> Request
        self._next_id = 0

    def submit(self, prompt_ids, sampling, priority=0, deadline_s=None,
               tenant=None, grammar=None):
        req = Request(self._next_id, list(prompt_ids),
                      sampling.validate(), priority=int(priority),
                      deadline_s=deadline_s, tenant=tenant,
                      grammar=grammar)
        self._next_id += 1
        self.queue.append(req)
        return req

    def overtake_cap(self, victim, overtaker, window=None):
        """The overtake budget of ``victim`` against ``overtaker``: how
        many times ``victim`` may be bypassed in total before requests
        like ``overtaker`` must stop passing it.  Equal (or lower)
        priority keeps the plain reorder window; each point of priority
        advantage adds one more window's worth of budget.  This single
        cap bounds BOTH reorder sources — same-bucket co-batching and
        the priority promotion pass — so the documented starvation
        bound (``window * (1 + max priority gap)`` total overtakes)
        holds across them combined.

        A batch-lane victim (``priority < 0``) has NO budget limit
        against interactive traffic: the cap is infinite, so the
        starvation bound applies only among interactive tiers (and
        among batch requests themselves, which keep the plain
        window)."""
        w = self.reorder_window if window is None else int(window)
        if victim.priority < 0 <= overtaker.priority:
            return float("inf")
        gap = max(0, int(overtaker.priority) - int(victim.priority))
        return w * (1 + gap)

    def promote(self, window=None):
        """Bounded stable priority promotion: bubble higher-priority
        queued requests toward the head, one overtake at a time, each
        hop allowed only while the passed request still has overtake
        budget (:meth:`overtake_cap`) — and charged against it.  Equal
        priorities never reorder (FIFO preserved), ``resumed`` requests
        are never passed (re-admission order after preemption is part
        of the bitwise-replay contract), and with ``window == 0`` the
        cap is 0 so this is a no-op (strict FIFO).  Idempotent: once
        the queue is priority-sorted within budget, no further hops
        happen and no further budget is charged."""
        q = list(self.queue)
        if len(q) < 2 or all(r.priority == q[0].priority for r in q):
            return
        out = []
        for r in q:
            pos = len(out)
            while pos > 0:
                s = out[pos - 1]
                if (s.resumed or s.priority >= r.priority
                        or s.bypassed >= self.overtake_cap(s, r, window)):
                    break
                pos -= 1
            for s in out[pos:]:
                s.bypassed += 1
            out.insert(pos, r)
        self.queue = deque(out)

    def admissible(self, free_slots):
        """Pop up to free_slots queued requests in strict FIFO order
        (join happens at the next decode-step boundary)."""
        out = []
        while self.queue and len(out) < free_slots:
            out.append(self.queue.popleft())
        return out

    def shed_victims(self, max_queue):
        """Load-shedding selection (the degradation ladder's level 3):
        the queued requests to drop so at most ``max_queue`` remain —
        lowest priority first, newest first within a priority, and
        never a ``resumed`` request (its tokens are already streamed to
        a client; shedding it would break the zero-dropped-tokens
        contract).  Pure selection: the victims are still queued when
        this returns — the caller aborts them, which removes them."""
        excess = len(self.queue) - max(0, int(max_queue))
        if excess <= 0:
            return []
        sheddable = [r for r in self.queue if not r.resumed]
        sheddable.sort(key=lambda r: (r.priority, -r.request_id))
        return sheddable[:excess]

    def pop_batch(self, free_slots, bucket_of=None, window=None):
        """Pop one co-bucketed admission batch of up to ``free_slots``
        requests.

        The queue head anchors the batch — it is ALWAYS admitted, so
        FIFO heads never starve.  The scan then extends the batch with
        later queued requests whose ``bucket_of(req)`` equals the
        anchor's, subject to the reorder window ``window`` (default: the
        scheduler's ``reorder_window``):

        * a contiguous same-bucket run behind the head batches freely
          (no reordering happens, so no window applies);
        * once any request has been skipped, admitting a request from
          behind it counts as an overtake; a request is never overtaken
          more than ``window`` times in total, and no admission reaches
          past the window once a skip exists;
        * a ``resumed`` request (preempted, waiting to be re-admitted)
          shares the head anchor's exemption: admitting it restores the
          order the preemption disturbed, so it neither consumes the
          window nor increments anyone's ``bypassed`` counter;
        * priorities widen the budget per overtaken request
          (:meth:`overtake_cap`): a :meth:`promote` pass runs first so
          higher-priority requests reach the head within budget, and a
          same-bucket join is allowed while every skipped request still
          has budget *against that candidate's priority*.

        With ``bucket_of=None`` or ``window<=0`` this degrades to strict
        FIFO (``admissible``), batching only the contiguous same-bucket
        prefix when ``bucket_of`` is given.
        """
        if free_slots <= 0 or not self.queue:
            return []
        self.promote(window)
        if bucket_of is None:
            return self.admissible(free_slots)
        w = self.reorder_window if window is None else int(window)
        q = list(self.queue)
        anchor_bucket = bucket_of(q[0])
        batch = [q[0]]
        skipped = []
        # once the reorder window is exhausted the batch is SEALED for
        # ordinary requests, but the scan keeps walking: resumes restore
        # order rather than reorder, so they may still join
        sealed = False
        for idx in range(1, len(q)):
            if len(batch) >= free_slots:
                break
            r = q[idx]
            if r.resumed and bucket_of(r) == anchor_bucket:
                batch.append(r)  # head-anchor exemption for resumes
                continue
            if sealed:
                continue
            if (any(s.priority >= 0 for s in skipped)
                    and idx >= max(w, 1)):
                sealed = True    # reordering beyond the window forbidden
                continue         # (batch-lane skips don't bound the scan)
            if bucket_of(r) == anchor_bucket:
                if any(s.bypassed >= self.overtake_cap(s, r, w)
                       for s in skipped):
                    sealed = True  # someone ahead is at their overtake cap
                    continue
                batch.append(r)
                for s in skipped:
                    s.bypassed += 1
            else:
                skipped.append(r)
                if w <= 0 or (r.priority >= 0 and r.bypassed >= w):
                    sealed = True  # nobody may pass this request anymore
        taken = {id(r) for r in batch}
        self.queue = deque(r for r in q if id(r) not in taken)
        return batch

    def start(self, req, slot):
        req.status = RUNNING
        req.slot = slot
        req.resumed = False
        req.admit_time = time.time()
        self.running[slot] = req

    def finish(self, req):
        req.status = FINISHED
        del self.running[req.slot]

    def requeue_front(self, req):
        """Preempt a RUNNING request back to the queue head: it gives up
        its slot (and, in the paged engine, its KV blocks) but keeps its
        generated tokens, and is first in line to be re-admitted.  The
        engine re-prefills prompt + generated-so-far on re-admission, so
        preemption is invisible in the output stream."""
        del self.running[req.slot]
        req.status = WAITING
        req.slot = None
        req.resumed = True
        self.queue.appendleft(req)

    @property
    def queue_depth(self):
        return len(self.queue)

    @property
    def has_work(self):
        return bool(self.queue or self.running)
