"""``paddle.profiler``, the counterpart of ``paddle_tpu/profiler/__init__.py``,
over ``torch.profiler`` (host spans, and the card's kernels through
CUPTI) where JAX's stands over ``jax.profiler``.

``make_scheduler`` gives JAX's states step for step; a ``Profiler``
records the steps its scheduler marks ``RECORD``/``RECORD_AND_RETURN``
(the ``(start, end)`` form records ``[start, end)`` once; no scheduler
records from ``start`` to ``stop``), warming the tracer up in the step
before a window, calls ``on_trace_ready`` when a window closes, and
``export`` writes the last window as a chrome trace.
``timer_only`` keeps only the step timer behind ``step_info`` and
``summary`` (step times, then the histograms of
``observability.metrics``).  A profiler that cannot start its trace
raises: JAX's carries on without one, the port's does not.
``RecordEvent`` is ``torch.profiler.record_function``.  The counter
registry (``register_counter_provider``, ``counters``) is a facade over
``observability.metrics``, as JAX's.
"""

from __future__ import annotations

import contextlib
import enum
import os
import tempfile
import time

import numpy as np
import torch
from torch import profiler as _tp


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    total = closed + ready + record

    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        if repeat and s >= repeat * total:
            return ProfilerState.CLOSED
        pos = s % total
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == total - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


#: each state as torch.profiler's schedule action
_ACTIONS = {ProfilerState.CLOSED: _tp.ProfilerAction.NONE,
            ProfilerState.READY: _tp.ProfilerAction.WARMUP,
            ProfilerState.RECORD: _tp.ProfilerAction.RECORD,
            ProfilerState.RECORD_AND_RETURN:
                _tp.ProfilerAction.RECORD_AND_SAVE}


def export_chrome_tracing(dir_name, worker_name=None):
    """An ``on_trace_ready`` handler that writes each window's chrome
    trace into ``dir_name`` as ``<worker_name>.<ms>.json``."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        prof._export_dir = dir_name
        name = worker_name or f"host_{os.getpid()}"
        prof.export(os.path.join(
            dir_name, f"{name}.{int(time.time() * 1e3)}.json"))

    return handler


export_protobuf = export_chrome_tracing


def _activities(targets):
    if targets is None:
        targets = [ProfilerTarget.CPU] + (
            [ProfilerTarget.GPU] if torch.cuda.is_available() else [])
    acts = []
    for t in targets:
        if t == ProfilerTarget.CPU:
            acts.append(_tp.ProfilerActivity.CPU)
        elif t == ProfilerTarget.GPU:
            acts.append(_tp.ProfilerActivity.CUDA)
        else:
            raise ValueError(f"profiler target {t} is not on this build")
    return acts


class Profiler:
    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False, emit_nvtx=False):
        # the tuple form records [start, end) once (repeat=1: the default
        # repeat=0 would cycle the window forever)
        self._scheduler = scheduler if callable(scheduler) else (
            make_scheduler(closed=scheduler[0], ready=0,
                           record=scheduler[1] - scheduler[0], repeat=1)
            if isinstance(scheduler, (tuple, list)) else None)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._options = dict(record_shapes=record_shapes,
                             profile_memory=profile_memory,
                             with_flops=with_flops)
        self._activities = None if timer_only else _activities(targets)
        self._prof = None
        self._step = 0
        self._export_dir = os.environ.get(
            "PADDLE_TPU_PROFILE_DIR",
            os.path.join(tempfile.gettempdir(), "paddle_tpu_profile"))
        self._step_times = []
        self._last_step_t = None

    def _ready(self, prof):
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)

    def _action(self, step):
        """torch's action for ``step``: the state's, but a ``CLOSED`` step
        right before a recorded one warms the tracer up (``WARMUP``
        records nothing), as the ``READY`` step of Paddle's own tuple
        form does: a window started cold lost its first kernels' records
        on the H100."""
        state = self._scheduler(step)
        if state == ProfilerState.CLOSED and self._scheduler(step + 1) in (
                ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            return _tp.ProfilerAction.WARMUP
        return _ACTIONS[state]

    def start(self):
        """Start the step timer and, unless ``timer_only``, the trace;
        raises where the trace cannot start."""
        self._last_step_t = time.time()
        if not self._timer_only:
            schedule = None if self._scheduler is None else self._action
            self._prof = _tp.profile(
                activities=self._activities, schedule=schedule,
                on_trace_ready=self._ready, **self._options)
            self._prof.start()
        return self

    def stop(self):
        """Stop the trace (a window still open is handed to
        ``on_trace_ready``, as without a scheduler)."""
        if self._prof is not None:
            self._prof.stop()
        elif self._on_trace_ready is not None:
            self._on_trace_ready(self)

    def step(self, num_samples=None):
        now = time.time()
        if self._last_step_t is not None:
            self._step_times.append((now - self._last_step_t, num_samples))
        self._last_step_t = now
        self._step += 1
        if self._prof is not None:
            self._prof.step()

    def step_info(self, unit=None):
        if not self._step_times:
            return ""
        dt, ns = self._step_times[-1]
        ips = (ns / dt) if (ns and dt > 0) else (1.0 / dt if dt > 0 else 0.0)
        return f"batch_cost: {dt:.5f} s, ips: {ips:.3f} {unit or 'steps'}/s"

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        times = [t for t, _ in self._step_times]
        if not times:
            return "no steps recorded"
        # one sample has no spread: it is every quantile
        p50, p99 = ((times[0], times[0]) if len(times) == 1 else
                    (float(np.percentile(times, 50)),
                     float(np.percentile(times, 99))))
        lines = [f"steps: {len(times)}  avg: {np.mean(times)*1e3:.3f} ms  "
                 f"p50: {p50*1e3:.3f} ms  p99: {p99*1e3:.3f} ms"]
        lines.extend(self._histogram_lines())
        return "\n".join(lines)

    @staticmethod
    def _histogram_lines():
        """One line per observability histogram with data."""
        from ..observability import metrics as _obs_metrics

        lines = []
        for name, fam in sorted(_obs_metrics.default_registry()
                                .metrics().items()):
            if not isinstance(fam, _obs_metrics.Histogram):
                continue
            for label_s, st in fam.snapshot_values().items():
                if not st.get("count"):
                    continue
                suffix = f"{{{label_s}}}" if label_s else ""
                lines.append(
                    f"  {name}{suffix}: n={st['count']} "
                    f"mean={st['mean']:.6f} p50={st['p50']:.6f} "
                    f"p95={st['p95']:.6f} p99={st['p99']:.6f}")
        return lines

    def export(self, path=None, format="json"):
        """Write the last recorded window as a chrome trace to ``path``
        (default ``<export dir>/trace.json``) and return the path."""
        if self._prof is None:
            raise RuntimeError("export: a timer_only profiler records no "
                               "trace")
        if format != "json":
            raise ValueError(f"export: format {format!r} (json only)")
        path = path or os.path.join(self._export_dir, "trace.json")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._prof.export_chrome_trace(path)
        return path

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class RecordEvent:
    """A named span in the trace (``torch.profiler.record_function``)."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._span = None

    def begin(self):
        self._span = _tp.record_function(self.name)
        self._span.__enter__()

    def end(self):
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def load_profiler_result(filename):
    raise NotImplementedError("open the chrome trace with Perfetto or "
                              "chrome://tracing")


@contextlib.contextmanager
def profiler_guard(*a, **k):
    p = Profiler()
    p.start()
    try:
        yield p
    finally:
        p.stop()


# the counter registry: subsystems (the serving Engine, ...) publish
# live counters in observability.metrics; these names are JAX's facade


def register_counter_provider(name, provider):
    """Register a zero-arg callable returning ``{counter: value}`` under
    ``name`` (a later registration replaces an earlier one)."""
    from ..observability import metrics as _obs_metrics

    _obs_metrics.register_provider(name, provider)


def unregister_counter_provider(name):
    from ..observability import metrics as _obs_metrics

    _obs_metrics.unregister_provider(name)


def counters():
    """``{name: {counter: value}}`` of every registered provider (one that
    raises is reported as an error string)."""
    from ..observability import metrics as _obs_metrics

    return _obs_metrics.provider_counters()
