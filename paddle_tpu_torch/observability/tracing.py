"""Request-scoped tracing: per-request flight records for the serving
engine (the port's copy of ``paddle_tpu/observability/tracing.py``).

Observability phase 1 (metrics/events/span) answers aggregate questions
— "what is TTFT p95", "how deep is the queue".  This module answers the
per-request one production debugging actually starts from: *what
happened to request 17381* — when it queued, which prefill batch
admitted it and how many prompt tokens the prefix cache served, every
decode horizon it rode (tokens emitted, speculative accept length), each
preemption/resume round-trip, and how it ended.

Two pieces:

* :class:`RequestTrace` — the flight record the engine attaches to a
  ``Request`` at submit.  A trace is a monotonic-clock event list of
  ``(kind, t, args)`` tuples; kinds are the engine's lifecycle
  transitions (``queued``/``prefill``/``first_token``/``decode``/
  ``preempt``/``resume``/``finish``/``abort``).  Appends are one tuple
  per lifecycle transition per request — O(1), no locks on the hot path
  (CPython list.append is atomic under the GIL; readers snapshot with
  ``list()``), so tracing rides decode without measurable overhead.
* :class:`FlightRecorder` — the bounded retention policy: ALL currently
  live traces are pinned (a live request must always be debuggable, no
  matter how old), plus a drop-oldest ring of the last N *finished*
  traces.  ``to_json()`` reconstructs everything as plain dicts for the
  ``/debug/requests`` telemetry endpoint; ``chrome_events()`` renders
  each trace as a per-request async span (``b``/``n``/``e`` with
  ``id=request_id``) in the Chrome Trace Event format, mergeable into
  :func:`events.export_chrome_trace` for Perfetto.

The event sequence is the engine's ground truth restated per request:
``sum(decode.tokens) + first_token`` equals the request's
``n_generated``, ``prefill.prefix_hit_tokens`` equals its prefix-cache
credit, and the preempt/resume pairs count its swap round-trips —
tested against the engine counters under continuous batching with
preemption and speculative decoding enabled.
"""

from __future__ import annotations

import collections
import json
import threading
import time

#: lifecycle event kinds, in the order a request may emit them
QUEUED = "queued"
GATEWAY = "gateway"          # accepted by the HTTP gateway: records the
                             # receive->queued admission hop (hop_s) plus
                             # tenant/priority — present only for requests
                             # that entered through the serving gateway
PREFILL = "prefill"          # first admission: batched fused prefill
FIRST_TOKEN = "first_token"  # sampled by the prefill dispatch (TTFT)
DECODE = "decode"            # one fused decode horizon this lane rode
PREEMPT = "preempt"          # swapped out under KV block pressure
SWAP_OUT = "swap_out"        # tiered KV: the preempted lane's block
                             # chain was saved into the host arena
                             # (records blocks + bytes moved) — always
                             # paired with the preceding PREEMPT
SWAP_IN = "swap_in"          # tiered KV: host-arena blocks were
                             # uploaded and re-bound for this request's
                             # re-admission instead of re-prefilled
                             # (records blocks, bytes, averted tokens)
RESUME = "resume"            # re-admission re-prefill after a preempt
FAILOVER = "failover"        # adopted from a dead replica: this trace's
                             # request resumes another engine's stream
                             # (records from_replica + resumed_tokens)
FINISH = "finish"            # retired: EOS or max-tokens
ABORT = "abort"              # cancelled by the caller

#: kinds that terminate a trace
TERMINAL = (FINISH, ABORT)

DEFAULT_CAPACITY = 256


class RequestTrace:
    """The flight record of one serving request.

    ``events`` is a list of ``(kind, t, args)`` tuples where ``t`` is
    seconds since the trace was created on the **monotonic** clock
    (durations between lifecycle events are exact even if the wall
    clock steps); ``wall0`` anchors the trace to wall time so exported
    chrome spans line up with the process event ring."""

    __slots__ = ("request_id", "engine", "wall0", "_mono0", "events")

    def __init__(self, request_id, engine=""):
        self.request_id = request_id
        self.engine = engine
        self.wall0 = time.time()
        self._mono0 = time.monotonic()
        self.events = []

    def add(self, kind, **args):
        """Append one lifecycle event (monotonic-stamped).  Returns the
        event's args dict: the engine patches dispatch-derived fields
        (program-card cost shares) into it after the compiled call,
        when the card is actually known."""
        self.events.append((kind, time.monotonic() - self._mono0, args))
        return args

    # ------------------------------------------------------------ queries
    def _snapshot(self):
        return list(self.events)

    @property
    def finished(self):
        evs = self._snapshot()
        return bool(evs) and evs[-1][0] in TERMINAL

    @property
    def duration_s(self):
        """Seconds from submit to the last recorded event."""
        evs = self._snapshot()
        return evs[-1][1] if evs else 0.0

    def counts(self):
        """Engine-counter view reconstructed from the event sequence
        alone: tokens emitted, prefix-hit tokens, preemptions, decode
        horizons ridden, speculative accepted tokens, and the request's
        cost bill — program-card FLOP/byte shares summed over every
        prefill/resume/decode dispatch it rode (the unit a fleet router
        or per-tenant quota bills against; summed across requests these
        reconstruct the engine's dispatch totals)."""
        tokens = prefix_hit = preempts = horizons = accepted = 0
        aborted = failovers = resumed_tokens = forced = 0
        swap_ins = swap_outs = swap_in_bytes = swap_out_bytes = 0
        flops = bytes_est = 0.0
        for kind, _, args in self._snapshot():
            if kind == FIRST_TOKEN:
                tokens += 1
            elif kind == ABORT:
                aborted += 1
            elif kind == DECODE:
                tokens += args.get("tokens", 0)
                accepted += args.get("accepted", 0)
                forced += args.get("forced", 0)
                horizons += 1
            elif kind in (PREFILL, RESUME):
                # last admission wins, matching the engine's
                # req.prefix_hit_tokens (overwritten on re-admission)
                prefix_hit = args.get("prefix_hit_tokens", prefix_hit)
            elif kind == PREEMPT:
                preempts += 1
            elif kind == SWAP_OUT:
                swap_outs += 1
                swap_out_bytes += args.get("bytes", 0)
            elif kind == SWAP_IN:
                swap_ins += 1
                swap_in_bytes += args.get("bytes", 0)
            elif kind == FAILOVER:
                # tokens resumed from the dead replica are NOT counted
                # as emitted by THIS trace's engine — per-engine sums
                # still reconcile against engine counters exactly
                failovers += 1
                resumed_tokens = args.get("resumed_tokens",
                                          resumed_tokens)
            if kind in (PREFILL, RESUME, DECODE):
                flops += args.get("flops_est", 0.0)
                bytes_est += args.get("bytes_est", 0.0)
        return {"tokens_emitted": tokens, "prefix_hit_tokens": prefix_hit,
                "preemptions": preempts, "decode_horizons": horizons,
                "spec_accepted_tokens": accepted,
                "spec_forced_tokens": forced, "aborted": aborted,
                "failovers": failovers, "resumed_tokens": resumed_tokens,
                "swap_ins": swap_ins, "swap_outs": swap_outs,
                "swap_in_bytes": swap_in_bytes,
                "swap_out_bytes": swap_out_bytes,
                "flops_est": flops, "bytes_est": bytes_est}

    def to_json(self):
        """Plain-dict reconstruction (the /debug/requests payload)."""
        evs = self._snapshot()
        return {
            "request_id": self.request_id,
            "engine": self.engine,
            "submit_wall_time": self.wall0,
            "finished": bool(evs) and evs[-1][0] in TERMINAL,
            "duration_s": round(evs[-1][1], 6) if evs else 0.0,
            "counts": self.counts(),
            "events": [dict(args, kind=kind, t=round(t, 6))
                       for kind, t, args in evs],
        }

    def chrome_events(self):
        """This trace as one async span in the Chrome Trace Event
        format: ``b`` at submit, an async instant (``n``) per lifecycle
        event, and ``e`` at the terminal event (open-ended while the
        request is live).  All share ``id=request_id`` so Perfetto draws
        one row per request."""
        import os

        pid = os.getpid()
        rid = str(self.request_id)
        base = {"cat": "serving.request", "pid": pid, "tid": 0,
                "id": rid}
        out = [dict(base, name=f"request {rid}", ph="b",
                    ts=self.wall0 * 1e6,
                    args={"engine": self.engine})]
        for kind, t, args in self._snapshot():
            ts = (self.wall0 + t) * 1e6
            out.append(dict(base, name=kind, ph="n", ts=ts,
                            args={k: _jsonable(v)
                                  for k, v in args.items()}))
            if kind in TERMINAL:
                out.append(dict(base, name=f"request {rid}", ph="e",
                                ts=ts))
        return out


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


class FlightRecorder:
    """Bounded retention over request traces: every LIVE trace is
    pinned (attach/finish bracket a request's life), finished traces
    fall off a drop-oldest ring of ``capacity``.  Thread-safe: the
    engine writes from its driving thread, the telemetry server reads
    from its own."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._live = {}                    # request_id -> RequestTrace
        self._done = collections.deque(maxlen=int(capacity))
        self._dropped = 0
        self._finished_total = 0

    @property
    def capacity(self):
        return self._done.maxlen

    @property
    def dropped(self):
        """Finished traces that fell off the retention ring."""
        return self._dropped

    def attach(self, trace):
        """Register a live trace (called at submit)."""
        with self._lock:
            self._live[trace.request_id] = trace
        return trace

    def finish(self, trace):
        """Move a trace from the live set to the finished ring (called
        at retire/abort).  Unknown traces are adopted — a recorder can
        be swapped in mid-flight."""
        with self._lock:
            self._live.pop(trace.request_id, None)
            if len(self._done) == self._done.maxlen:
                self._dropped += 1
            self._done.append(trace)
            self._finished_total += 1

    def live(self):
        """All currently-live traces (always fully retained)."""
        with self._lock:
            return list(self._live.values())

    def recent(self):
        """The retained finished traces, oldest first."""
        with self._lock:
            return list(self._done)

    def get(self, request_id):
        with self._lock:
            if request_id in self._live:
                return self._live[request_id]
            for tr in self._done:
                if tr.request_id == request_id:
                    return tr
        return None

    def to_json(self):
        return {
            "capacity": self.capacity,
            "live_count": len(self._live),
            "finished_retained": len(self._done),
            "finished_total": self._finished_total,
            "dropped_finished": self._dropped,
            "live": [t.to_json() for t in self.live()],
            "recent": [t.to_json() for t in self.recent()],
        }

    def chrome_events(self):
        """Per-request async spans for every retained trace, mergeable
        into ``events.export_chrome_trace(extra=...)``."""
        out = []
        for tr in self.recent() + self.live():
            out.extend(tr.chrome_events())
        return out

    def export_chrome_trace(self, file=None):
        """Standalone chrome-trace document of the retained traces."""
        doc = {
            "traceEvents": sorted(self.chrome_events(),
                                  key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
            "metadata": {"producer": "paddle_tpu_torch.observability.tracing",
                         "dropped_finished_traces": self._dropped},
        }
        text = json.dumps(doc)
        if file is not None:
            if hasattr(file, "write"):
                file.write(text)
            else:
                with open(file, "w") as f:
                    f.write(text)
        return text

    def clear(self):
        with self._lock:
            self._live.clear()
            self._done.clear()
            self._dropped = 0
            self._finished_total = 0
