"""Bounded structured event timeline + chrome-trace export (the port's
copy of ``paddle_tpu/observability/events.py``).

Every subsystem appends typed host events here — serving slot
alloc/retire, preemptions, degradation transitions, injected faults,
failovers — into ONE process-wide ring buffer (old events fall off;
recording never blocks or grows unboundedly).

``export_chrome_trace()`` emits the Chrome Trace Event JSON format
(``{"traceEvents": [...]}``, ts in microseconds, ``B``/``E``/``i``
phases), loadable in ``chrome://tracing`` / Perfetto — drop it next to a
``torch.profiler`` trace and the host timeline interleaves with the
device one.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

DEFAULT_CAPACITY = 4096

#: phases (chrome trace event ``ph`` values)
BEGIN = "B"
END = "E"
INSTANT = "i"
COMPLETE = "X"
#: async phases — for spans that overlap rather than nest on one thread
#: (e.g. serving requests living across many engine steps); require an
#: ``id`` correlating the pair
ASYNC_BEGIN = "b"
ASYNC_END = "e"


class Event:
    """One timeline entry. ``ts`` is ``time.time()`` seconds (wall clock,
    so host events line up with device-trace timestamps); ``dur`` is
    seconds for COMPLETE events, None otherwise."""

    __slots__ = ("name", "phase", "ts", "dur", "cat", "tid", "args", "id")

    def __init__(self, name, phase=INSTANT, ts=None, dur=None, cat="host",
                 tid=None, args=None, id=None):
        self.name = name
        self.phase = phase
        self.ts = time.time() if ts is None else ts
        self.dur = dur
        self.cat = cat
        self.tid = threading.get_ident() if tid is None else tid
        self.args = dict(args) if args else {}
        self.id = id

    def to_chrome(self):
        ev = {
            "name": self.name,
            "ph": self.phase,
            "ts": self.ts * 1e6,          # chrome trace wants microseconds
            "pid": os.getpid(),
            "tid": self.tid,
            "cat": self.cat,
        }
        if self.phase == COMPLETE:
            ev["dur"] = (self.dur or 0.0) * 1e6
        if self.phase == INSTANT:
            ev["s"] = "t"                  # thread-scoped instant
        if self.id is not None:
            ev["id"] = str(self.id)
        if self.args:
            ev["args"] = {k: _jsonable(v) for k, v in self.args.items()}
        return ev

    def __repr__(self):
        return (f"Event({self.name!r}, ph={self.phase}, ts={self.ts:.6f}, "
                f"args={self.args})")


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


class EventLog:
    """Thread-safe bounded ring buffer of Events."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=capacity)
        self._dropped = 0

    @property
    def capacity(self):
        return self._ring.maxlen

    def set_capacity(self, capacity):
        with self._lock:
            old = list(self._ring)
            self._ring = collections.deque(old[-capacity:],
                                           maxlen=int(capacity))

    def record(self, name, phase=INSTANT, cat="host", dur=None, args=None,
               ts=None, id=None):
        ev = Event(name, phase=phase, ts=ts, dur=dur, cat=cat, args=args,
                   id=id)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(ev)
        return ev

    def begin(self, name, cat="host", **args):
        return self.record(name, phase=BEGIN, cat=cat, args=args)

    def end(self, name, cat="host", **args):
        return self.record(name, phase=END, cat=cat, args=args)

    def instant(self, name, cat="host", **args):
        return self.record(name, phase=INSTANT, cat=cat, args=args)

    def events(self, name=None, cat=None):
        with self._lock:
            evs = list(self._ring)
        if name is not None:
            evs = [e for e in evs if e.name == name]
        if cat is not None:
            evs = [e for e in evs if e.cat == cat]
        return evs

    @property
    def dropped(self):
        return self._dropped

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    def export_chrome_trace(self, file=None, extra=None):
        """Chrome Trace Event JSON for the current ring contents, sorted
        by timestamp (chrome requires monotonically non-decreasing ts
        within a (pid, tid); sorting globally satisfies the stricter
        whole-file ordering our tests assert). ``file`` may be a path or
        a writable file object; returns the JSON string either way.

        ``extra`` merges pre-rendered chrome events (dicts with a
        ``ts`` in µs — e.g. the flight recorder's per-request async
        spans) into the same timeline.  The metadata header carries
        ``dropped_events`` plus process identity (``process_name``,
        ``git_sha``) so a truncated ring or a stale build is visible
        right in Perfetto."""
        chrome = [e.to_chrome() for e in self.events()]
        if extra:
            chrome.extend(extra)
        chrome.sort(key=lambda e: e["ts"])
        doc = {
            "traceEvents": chrome,
            "displayTimeUnit": "ms",
            "metadata": {"producer": "paddle_tpu_torch.observability",
                         "dropped_events": self._dropped,
                         "process_name": _process_name(),
                         "git_sha": _git_sha(),
                         "mesh": _mesh_meta()},
        }
        text = json.dumps(doc)
        if file is not None:
            if hasattr(file, "write"):
                file.write(text)
            else:
                with open(file, "w") as f:
                    f.write(text)
        return text


def _process_name():
    import sys

    return f"python:{os.path.basename(sys.argv[0] or 'interactive')}"


def _mesh_meta():
    """Process-group summary for the trace header: the
    ``torch.distributed`` world size and this rank while a process group
    is live, None otherwise.  Guarded: trace export must never fail
    because the distributed stack is absent or half-initialized."""
    try:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return None
        return {"world_size": dist.get_world_size(),
                "rank": dist.get_rank()}
    except Exception:                # pragma: no cover - defensive
        return None


_GIT_SHA = None


def _git_sha():
    """Short git SHA of the working tree, best-effort and cached (trace
    export must never fail or block on a missing git)."""
    global _GIT_SHA
    if _GIT_SHA is None:
        try:
            import subprocess

            _GIT_SHA = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=5,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.strip() or "unknown"
        except Exception:
            _GIT_SHA = "unknown"
    return _GIT_SHA


# ------------------------------------------------------------- default log
_default_log = EventLog()


def default_log():
    return _default_log


def record(name, phase=INSTANT, cat="host", dur=None, args=None, ts=None,
           id=None):
    return _default_log.record(name, phase=phase, cat=cat, dur=dur,
                               args=args, ts=ts, id=id)


def begin(name, cat="host", **args):
    return _default_log.begin(name, cat=cat, **args)


def end(name, cat="host", **args):
    return _default_log.end(name, cat=cat, **args)


def instant(name, cat="host", **args):
    return _default_log.instant(name, cat=cat, **args)


def events(name=None, cat=None):
    return _default_log.events(name=name, cat=cat)


def clear():
    _default_log.clear()


def set_capacity(capacity):
    _default_log.set_capacity(capacity)


def export_chrome_trace(file=None, extra=None):
    return _default_log.export_chrome_trace(file=file, extra=extra)
