"""SLO tracking: declared objectives, rolling compliance, multi-window
burn rate (the port's copy of ``paddle_tpu/observability/slo.py``).

An :class:`Objective` declares one service-level objective in the
classic SRE shape — "for ``target`` of observations, ``value`` must be
``<= threshold``" (TTFT p95 < 500 ms is ``threshold=0.5,
target=0.95``; abort rate < 5 % is 0/1 error observations with
``threshold=0.5, target=0.95``).  Every observation lands in TWO
rolling windows, a fast one and a slow one, each backed by the SAME
bounded-reservoir machinery the metrics registry's Histograms use —
windows are sized in **observations (steps), not wall-clock seconds**,
so compliance math is deterministic under test (no sleeping, no clock
injection).

Per window the tracker computes:

* **compliance** — fraction of the window's observations that met the
  threshold (1.0 while the window is empty: no evidence of breach —
  but snapshots carry a per-window ``idle`` flag and a per-objective
  ``idle`` so consumers can tell "healthy" from "unmeasured"; the
  fleet attainment curves must not credit idle replicas);
* **burn rate** — ``(1 - compliance) / (1 - target)``: how many times
  faster than budget the error budget is burning (1.0 = exactly on
  budget, 20 = a full fast-window outage at target 0.95).

Breach detection is the standard multi-window AND: an objective is
unhealthy while BOTH windows burn above ``burn_threshold`` — the fast
window makes detection quick, the slow window keeps one bad step from
flapping, and recovery is fast because the fast window forgives as soon
as it refills with good observations.

:class:`SLOTracker` owns a set of objectives, publishes each as typed
gauges (``slo.compliance`` / ``slo.burn_rate`` per (objective, window),
``slo.objective_healthy`` per objective, and one overall
``slo.healthy``) and snapshots as JSON for ``/debug/slo``.  The overall
``slo_healthy`` signal is what the serving gateway will consume for
admission/shedding; today it drives the telemetry server's ``/readyz``.
"""

from __future__ import annotations

import threading

from .metrics import Histogram, Registry, default_registry

#: default window sizes, in observations ("fast 1m / slow 10m" at one
#: observation per second — but steps, so tests are deterministic)
DEFAULT_FAST_WINDOW = 64
DEFAULT_SLOW_WINDOW = 640

WINDOWS = ("fast", "slow")


class Objective:
    """One declared objective over a pair of step-sized windows."""

    def __init__(self, name, threshold, target=0.95,
                 fast_window=DEFAULT_FAST_WINDOW,
                 slow_window=DEFAULT_SLOW_WINDOW,
                 burn_threshold=1.0, unit="s", help=""):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if int(fast_window) < 1 or int(slow_window) < int(fast_window):
            raise ValueError("need slow_window >= fast_window >= 1")
        self.name = name
        self.threshold = float(threshold)
        self.target = float(target)
        self.burn_threshold = float(burn_threshold)
        self.unit = unit
        self.help = help
        # the rolling windows ARE histogram reservoirs: a private
        # registry keeps them off the process-wide exposition (the
        # tracker publishes derived gauges instead), while compliance
        # reads the same bounded ``samples`` deque Histogram percentiles
        # use
        self._reg = Registry()
        self._win = {
            "fast": Histogram(f"slo.window.{name}.fast",
                              reservoir=int(fast_window),
                              registry=self._reg),
            "slow": Histogram(f"slo.window.{name}.slow",
                              reservoir=int(slow_window),
                              registry=self._reg),
        }
        self._lock = threading.Lock()
        self.observations = 0
        self.breaches = 0

    def observe(self, value):
        """Record one observation into both windows."""
        value = float(value)
        with self._lock:
            self.observations += 1
            if value > self.threshold:
                self.breaches += 1
        for h in self._win.values():
            h.observe(value)

    def _samples(self, window):
        slot = self._win[window]._values.get(())
        return list(slot.samples) if slot is not None else []

    def window_size(self, window):
        return self._win[window].reservoir

    def compliance(self, window="fast"):
        """Fraction of the window's observations within threshold
        (1.0 while empty — an idle service is not in breach)."""
        samples = self._samples(window)
        if not samples:
            return 1.0
        good = sum(1 for v in samples if v <= self.threshold)
        return good / len(samples)

    def burn_rate(self, window="fast"):
        """Error-budget burn multiple: 1.0 = consuming exactly the
        budget ``1 - target`` allows, >1 = burning faster."""
        return (1.0 - self.compliance(window)) / (1.0 - self.target)

    @property
    def healthy(self):
        """Multi-window breach rule: unhealthy only while BOTH windows
        burn above ``burn_threshold``."""
        return not (self.burn_rate("fast") > self.burn_threshold
                    and self.burn_rate("slow") > self.burn_threshold)

    @property
    def idle(self):
        """True while BOTH windows are empty: compliance/burn report
        the vacuous defaults with zero evidence behind them.  A
        zero-traffic replica is "compliant" only in the sense that it
        was never measured — consumers building attainment curves must
        check this flag instead of crediting the 1.0."""
        return all(not self._samples(w) for w in WINDOWS)

    def snapshot(self):
        out = {
            "threshold": self.threshold,
            "target": self.target,
            "burn_threshold": self.burn_threshold,
            "unit": self.unit,
            "observations": self.observations,
            "breaches": self.breaches,
            "healthy": self.healthy,
            "idle": self.idle,
        }
        for w in WINDOWS:
            samples = len(self._samples(w))
            out[w] = {
                "window_steps": self.window_size(w),
                "samples": samples,
                # an empty window's compliance=1.0 is vacuous, not
                # evidence of health — the flag keeps the distinction
                "idle": samples == 0,
                "compliance": round(self.compliance(w), 6),
                "burn_rate": round(self.burn_rate(w), 6),
            }
        return out


class SLOTracker:
    """A named set of objectives plus their published gauges.

    ``tracker`` labels every gauge so two engines (or an engine and a
    gateway) in one process stay distinguishable.  Gauges refresh on
    every ``observe()`` — observation rate is request retirement rate,
    so publish cost is negligible."""

    def __init__(self, name="default", registry=None):
        self.name = name
        self._objectives = {}
        reg = default_registry() if registry is None else registry
        self._g_compliance = reg.gauge(
            "slo.compliance",
            "rolling fraction of observations within objective threshold")
        self._g_burn = reg.gauge(
            "slo.burn_rate",
            "error-budget burn multiple per (objective, window)")
        self._g_obj_healthy = reg.gauge(
            "slo.objective_healthy",
            "1 while the objective's multi-window burn rule holds")
        self._g_healthy = reg.gauge(
            "slo.healthy",
            "1 while every declared objective is healthy (readiness "
            "signal for admission/shedding)")
        self._publish_overall()

    # ------------------------------------------------------------ declare
    def declare(self, name, threshold, **kwargs):
        """Declare (or replace) an objective; returns it."""
        obj = Objective(name, threshold, **kwargs)
        self._objectives[name] = obj
        self._publish(obj)
        return obj

    def objective(self, name):
        return self._objectives.get(name)

    def objectives(self):
        return dict(self._objectives)

    def __len__(self):
        return len(self._objectives)

    # ------------------------------------------------------------ observe
    def observe(self, name, value):
        """Record one observation against a declared objective (unknown
        names are ignored — instrumentation points fire whether or not
        an operator declared an objective for them)."""
        obj = self._objectives.get(name)
        if obj is None:
            return
        obj.observe(value)
        self._publish(obj)

    def _publish(self, obj):
        for w in WINDOWS:
            self._g_compliance.set(obj.compliance(w), tracker=self.name,
                                   objective=obj.name, window=w)
            self._g_burn.set(obj.burn_rate(w), tracker=self.name,
                             objective=obj.name, window=w)
        self._g_obj_healthy.set(int(obj.healthy), tracker=self.name,
                                objective=obj.name)
        self._publish_overall()

    def _publish_overall(self):
        self._g_healthy.set(int(self.healthy), tracker=self.name)

    # ------------------------------------------------------------ queries
    @property
    def healthy(self):
        """The overall readiness signal: every objective healthy (a
        tracker with no objectives is vacuously healthy)."""
        return all(o.healthy for o in self._objectives.values())

    @property
    def idle(self):
        """True while every declared objective is idle (or none are
        declared): the tracker's ``healthy`` is vacuous — nothing was
        measured.  The fleet harness uses this to keep zero-traffic
        replicas out of attainment credit."""
        return all(o.idle for o in self._objectives.values())

    def snapshot(self):
        return {
            "tracker": self.name,
            "healthy": self.healthy,
            "idle": self.idle,
            "objectives": {n: o.snapshot()
                           for n, o in sorted(self._objectives.items())},
        }
