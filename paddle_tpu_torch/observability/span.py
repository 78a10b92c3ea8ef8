"""``span(name, **labels)`` — one context manager, three sinks (the port's
copy of ``paddle_tpu/observability/span.py``).

Entering a span simultaneously:

1. opens a ``torch.profiler.record_function`` range so the span shows
   up in a ``torch.profiler`` trace beside the kernels it launched;
2. appends matching begin/end events to the host timeline
   (``observability.events``), nesting-aware via a per-thread depth;
3. on exit, observes the span's wall seconds into the
   ``span.seconds`` histogram labeled by span name (+ user labels).

This is the single instrumentation idiom the instrumented subsystems
(the serving engine's prefill passes and decode steps) build on.
"""

from __future__ import annotations

import threading
import time

from . import events as _events
from . import metrics as _metrics

_tls = threading.local()

#: one histogram family for every span, labeled by name
SPAN_SECONDS = _metrics.histogram(
    "span.seconds", "wall seconds per observability span, by span name")


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_span():
    """Name of the innermost open span on this thread (None outside)."""
    s = _stack()
    return s[-1] if s else None


def span_depth():
    return len(_stack())


class span:
    """Context manager; also usable as a decorator-free timer via the
    ``elapsed`` attribute after exit."""

    def __init__(self, name, cat="host", event_args=None, **labels):
        """``labels`` key both the timeline events and the histogram —
        keep them LOW-CARDINALITY (a function name, a phase). Per-call
        detail (a file path, a request id) goes in ``event_args``, which
        reaches only the bounded event ring."""
        self.name = name
        self.cat = cat
        self.labels = labels
        self.event_args = dict(event_args) if event_args else {}
        self.elapsed = None
        self._t0 = None
        self._ann = None

    def __enter__(self):
        stack = _stack()
        try:
            import torch

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        except Exception:   # no profiler: the host timeline still works
            self._ann = None
        self._t0 = time.perf_counter()
        _events.record(self.name, phase=_events.BEGIN, cat=self.cat,
                       args=dict(self.labels, depth=len(stack),
                                 **self.event_args))
        stack.append(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = _stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self.elapsed = time.perf_counter() - self._t0
        try:
            _events.record(self.name, phase=_events.END, cat=self.cat,
                           args=dict(self.labels, depth=len(stack),
                                     seconds=round(self.elapsed, 9),
                                     error=exc_type.__name__ if exc_type
                                     else None, **self.event_args))
        finally:
            # the span must ALWAYS end: close the device annotation and
            # observe the histogram even if the event ring raised.  A
            # raising body tags the observation error=1 so error and
            # success latencies stay separable.
            if self._ann is not None:
                try:
                    self._ann.__exit__(exc_type, exc, tb)
                except Exception:
                    pass
            hist_labels = dict(self.labels)
            if exc_type is not None:
                hist_labels["error"] = 1
            SPAN_SECONDS.observe(self.elapsed, name=self.name,
                                 **hist_labels)
        return False
