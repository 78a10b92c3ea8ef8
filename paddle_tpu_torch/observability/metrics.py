"""Typed process-wide metrics registry (the port's copy of
``paddle_tpu/observability/metrics.py``, host Python only).

Three primitives, all label-aware and thread-safe (engine worker
threads and HTTP handler threads share one registry):

* ``Counter`` — monotonically increasing (tokens generated, cache hits);
* ``Gauge`` — set-to-current-value (queue depth, active slots);
* ``Histogram`` — fixed cumulative buckets for the prometheus exposition
  PLUS a bounded reservoir of raw samples for exact p50/p95/p99
  (step time, TTFT).

Two exports:

* ``snapshot()`` — one nested JSON-able dict of every metric (and every
  counter provider), the programmatic surface tests/dashboards poll;
* ``render_prometheus()`` — text exposition (``# HELP``/``# TYPE`` +
  sample lines) for scrape-style collection, byte for byte the JAX
  package's rendering of the same operations.

Counter providers (zero-arg callables returning ``{counter: value}`` per
subsystem, e.g. an engine's ``counters()``) register with
``register_provider`` / ``unregister_provider``.
"""

from __future__ import annotations

import collections
import math
import re
import threading

import numpy as np

#: default histogram bucket upper bounds (seconds-flavored: spans from
#: 100 µs dispatches to multi-minute compiles all land in a real bucket)
DEFAULT_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

#: raw samples kept per (histogram, label set) for exact percentiles
DEFAULT_RESERVOIR = 2048


def _label_key(labels):
    """Canonical hashable key for a label set: sorted (k, v-as-str)."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key):
    return ",".join(f"{k}={v}" for k, v in key)


def _label_prom(key):
    if not key:
        return ""
    quoted = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + quoted + "}"


def _escape(v):
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def _escape_help(v):
    """HELP text escapes only backslash and newline (quotes stay raw),
    per the exposition format spec."""
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v):
    """Render a sample value in canonical exposition form: whole
    numbers as ints, non-finite floats as ``NaN``/``+Inf``/``-Inf``
    (Python's ``nan``/``inf`` spellings are not in the grammar)."""
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    i = int(f)
    return str(i) if i == f else repr(f)


def _prom_name(name):
    """Prometheus metric names allow [a-zA-Z0-9_:]; dots become
    underscores (``serving.decode_steps`` -> ``serving_decode_steps``)."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


class Metric:
    """Base: a named family holding one value per label set."""

    kind = "untyped"

    def __init__(self, name, help="", registry=None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values = {}
        reg = _default_registry if registry is None else registry
        if reg is not None:
            reg._register(self)

    def _slot(self, labels):
        """Get-or-create the value slot for a label set (under lock)."""
        key = _label_key(labels)
        slot = self._values.get(key)
        if slot is None:
            with self._lock:
                slot = self._values.setdefault(key, self._new_slot())
        return slot

    def _new_slot(self):
        raise NotImplementedError

    def label_sets(self):
        return list(self._values.keys())

    def clear(self):
        with self._lock:
            self._values.clear()


class Counter(Metric):
    kind = "counter"

    def _new_slot(self):
        return [0.0]

    def inc(self, amount=1, **labels):
        if amount < 0:
            raise ValueError("Counter can only increase")
        slot = self._slot(labels)
        with self._lock:
            slot[0] += amount

    def value(self, **labels):
        slot = self._values.get(_label_key(labels))
        return 0 if slot is None else _as_scalar(slot[0])

    def snapshot_values(self):
        return {_label_str(k): _as_scalar(v[0])
                for k, v in sorted(self._values.items())}


class Gauge(Metric):
    kind = "gauge"

    def _new_slot(self):
        return [0.0]

    def set(self, value, **labels):
        slot = self._slot(labels)
        with self._lock:
            slot[0] = float(value)

    def inc(self, amount=1, **labels):
        slot = self._slot(labels)
        with self._lock:
            slot[0] += amount

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        slot = self._values.get(_label_key(labels))
        return 0 if slot is None else _as_scalar(slot[0])

    def snapshot_values(self):
        return {_label_str(k): _as_scalar(v[0])
                for k, v in sorted(self._values.items())}


class _HistSlot:
    __slots__ = ("counts", "sum", "count", "samples")

    def __init__(self, n_buckets, reservoir):
        self.counts = [0] * (n_buckets + 1)   # +inf tail bucket
        self.sum = 0.0
        self.count = 0
        self.samples = collections.deque(maxlen=reservoir)


class Histogram(Metric):
    """Fixed-bucket histogram + bounded raw-sample reservoir.

    Buckets are cumulative-le in the prometheus exposition; percentiles
    come from the raw reservoir (exact vs ``np.percentile`` while fewer
    than ``reservoir`` observations have been made, sliding-window
    thereafter)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS,
                 reservoir=DEFAULT_RESERVOIR, registry=None):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.reservoir = int(reservoir)
        super().__init__(name, help=help, registry=registry)

    def _new_slot(self):
        return _HistSlot(len(self.buckets), self.reservoir)

    def observe(self, value, **labels):
        value = float(value)
        slot = self._slot(labels)
        with self._lock:
            i = np.searchsorted(self.buckets, value, side="left")
            slot.counts[i] += 1
            slot.sum += value
            slot.count += 1
            slot.samples.append(value)

    def percentile(self, q, **labels):
        slot = self._values.get(_label_key(labels))
        if slot is None or not slot.samples:
            return None
        return float(np.percentile(np.asarray(slot.samples), q))

    def stats(self, **labels):
        slot = self._values.get(_label_key(labels))
        if slot is None:
            return None
        return self._slot_stats(slot)

    def _slot_stats(self, slot):
        out = {"count": slot.count, "sum": slot.sum}
        if slot.samples:
            arr = np.asarray(slot.samples)
            out["mean"] = float(arr.mean())
            out["p50"], out["p95"], out["p99"] = (
                float(v) for v in np.percentile(arr, (50, 95, 99)))
        cum = 0
        buckets = {}
        for le, c in zip(self.buckets, slot.counts):
            cum += c
            buckets[repr(le)] = cum
        buckets["+Inf"] = cum + slot.counts[-1]
        out["buckets"] = buckets
        return out

    def snapshot_values(self):
        return {_label_str(k): self._slot_stats(v)
                for k, v in sorted(self._values.items())}


class Registry:
    """A named collection of metrics plus the counter-provider registry.

    One process-wide default instance backs the module-level helpers;
    tests can build private registries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._providers = {}

    # ------------------------------------------------------------ metrics
    def _register(self, metric):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and type(existing) is not type(metric):
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{existing.kind}")
            self._metrics[metric.name] = metric

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m
        return cls(name, help=help, registry=self, **kwargs)

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS,
                  reservoir=DEFAULT_RESERVOIR):
        return self._get_or_create(Histogram, name, help,
                                   buckets=buckets, reservoir=reservoir)

    def get(self, name):
        return self._metrics.get(name)

    def metrics(self):
        return dict(self._metrics)

    def value(self, name, /, **labels):
        """Convenience for tests/assertions: the scalar value (Counter/
        Gauge) or stats dict (Histogram) for one (metric, label set).
        ``name`` is positional-only so a label may itself be called
        ``name`` (the span histogram's label scheme)."""
        m = self._metrics.get(name)
        if m is None:
            return None
        if isinstance(m, Histogram):
            return m.stats(**labels)
        return m.value(**labels)

    def reset(self):
        """Drop every recorded value (metric FAMILIES stay registered —
        instrumented modules hold references to them)."""
        with self._lock:
            for m in self._metrics.values():
                m.clear()

    # ------------------------------------------------------- providers
    def register_provider(self, name, provider):
        """A zero-arg callable returning a flat {counter: value} mapping
        for one subsystem (later registrations replace earlier ones)."""
        if not callable(provider):
            raise TypeError("provider must be callable")
        with self._lock:
            self._providers[name] = provider

    def unregister_provider(self, name):
        with self._lock:
            self._providers.pop(name, None)

    def provider_counters(self):
        """Snapshot every provider: {name: {counter: value}}; a provider
        that raises reports an error string instead of poisoning the
        snapshot."""
        with self._lock:
            items = list(self._providers.items())
        out = {}
        for name, provider in items:
            try:
                out[name] = dict(provider())
            except Exception as e:  # pragma: no cover - defensive
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # --------------------------------------------------------- exports
    def snapshot(self):
        """Nested JSON-able view of everything this registry knows."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = {"metrics": {}, "providers": self.provider_counters()}
        for name, m in metrics:
            out["metrics"][name] = {
                "type": m.kind,
                "help": m.help,
                "values": m.snapshot_values(),
            }
        return out

    def render_prometheus(self):
        """Text exposition format; providers render as untyped gauges
        under their subsystem name."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines = []
        for name, m in metrics:
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {_escape_help(m.help)}")
            lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, Histogram):
                for key in sorted(m._values):
                    slot = m._values[key]
                    cum = 0
                    for le, c in zip(m.buckets, slot.counts):
                        cum += c
                        lines.append(
                            f"{pname}_bucket"
                            f"{_label_prom(key + (('le', repr(le)),))} "
                            f"{cum}")
                    lines.append(
                        f"{pname}_bucket"
                        f"{_label_prom(key + (('le', '+Inf'),))} "
                        f"{slot.count}")
                    lines.append(
                        f"{pname}_sum{_label_prom(key)} "
                        f"{_fmt_value(slot.sum)}")
                    lines.append(
                        f"{pname}_count{_label_prom(key)} {slot.count}")
            else:
                for key in sorted(m._values):
                    lines.append(
                        f"{pname}{_label_prom(key)} "
                        f"{_fmt_value(m._values[key][0])}")
        for sub, counters in sorted(self.provider_counters().items()):
            base = _prom_name(sub)
            lines.append(f"# TYPE {base} gauge")
            for cname, v in sorted(counters.items()):
                if isinstance(v, (int, float)):
                    lines.append(
                        f"{base}{{counter=\"{_escape(cname)}\"}} "
                        f"{_fmt_value(v)}")
        return "\n".join(lines) + "\n"


def _as_scalar(v):
    """Counters/gauges hold floats internally; render whole numbers as
    ints so snapshots compare cleanly against expected counts.  NaN and
    infinities (gauges for unavailable analyses) pass through as-is —
    json.dumps spells them NaN/Infinity, like the text exposition."""
    f = float(v)
    if math.isnan(f) or math.isinf(f):
        return f
    i = int(f)
    return i if i == f else f


# ----------------------------------------------------- exposition checker
_EXPO_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_EXPO_LABEL_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")
_EXPO_VALUE = re.compile(
    r"(?:[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|NaN|[+-]?Inf)\Z")
_EXPO_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _parse_labels(raw, errors, lineno):
    """Parse the inside of ``{...}``; returns {name: value} or None on
    error.  Hand-rolled scanner because label VALUES may contain
    escaped quotes/commas a regex split would mangle."""
    labels = {}
    i, n = 0, len(raw)
    while i < n:
        eq = raw.find("=", i)
        if eq < 0:
            errors.append(f"line {lineno}: label without '=': {raw[i:]!r}")
            return None
        lname = raw[i:eq]
        if not _EXPO_LABEL_NAME.match(lname):
            errors.append(f"line {lineno}: bad label name {lname!r}")
            return None
        if eq + 1 >= n or raw[eq + 1] != '"':
            errors.append(f"line {lineno}: label value not quoted")
            return None
        j = eq + 2
        val = []
        while j < n:
            c = raw[j]
            if c == "\\":
                if j + 1 >= n or raw[j + 1] not in ('\\', '"', 'n'):
                    errors.append(
                        f"line {lineno}: bad escape in label value")
                    return None
                val.append({"\\": "\\", '"': '"', "n": "\n"}[raw[j + 1]])
                j += 2
            elif c == '"':
                break
            elif c == "\n":
                errors.append(
                    f"line {lineno}: raw newline in label value")
                return None
            else:
                val.append(c)
                j += 1
        else:
            errors.append(f"line {lineno}: unterminated label value")
            return None
        if lname in labels:
            errors.append(f"line {lineno}: duplicate label {lname!r}")
            return None
        labels[lname] = "".join(val)
        i = j + 1
        if i < n:
            if raw[i] != ",":
                errors.append(
                    f"line {lineno}: expected ',' between labels")
                return None
            i += 1
    return labels


def validate_exposition(text):
    """Parse-check a Prometheus text-exposition document against the
    0.0.4 grammar: comment/HELP/TYPE lines, sample-line shape, metric
    and label name charsets, label-value escaping, value syntax, TYPE
    declared at most once and before its samples, histogram structure
    (``le`` on ``_bucket`` lines), and (family, labels) uniqueness.

    Returns the number of sample lines on success; raises
    ``ValueError`` listing every violation otherwise."""
    errors = []
    types = {}          # family -> declared type
    seen_samples = set()  # (name, sorted label items)
    families_emitted = set()
    n_samples = 0
    for lineno, line in enumerate(text.split("\n"), start=1):
        if not line:
            continue
        if line != line.strip():
            errors.append(f"line {lineno}: leading/trailing whitespace")
            line = line.strip()
            if not line:
                continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] in ("HELP", "TYPE"):
                if len(parts) < 3 or not _EXPO_NAME.match(parts[2]):
                    errors.append(f"line {lineno}: bad {parts[1]} line")
                    continue
                if parts[1] == "TYPE":
                    mtype = parts[3].strip() if len(parts) > 3 else ""
                    if mtype not in _EXPO_TYPES:
                        errors.append(
                            f"line {lineno}: unknown type {mtype!r}")
                    if parts[2] in types:
                        errors.append(
                            f"line {lineno}: duplicate TYPE for "
                            f"{parts[2]!r}")
                    if parts[2] in families_emitted:
                        errors.append(
                            f"line {lineno}: TYPE for {parts[2]!r} "
                            "after its samples")
                    types[parts[2]] = mtype
            continue  # other comments are free-form
        # ---- sample line: name[{labels}] value [timestamp]
        rest = line
        brace = rest.find("{")
        if brace >= 0:
            name = rest[:brace]
            close = rest.rfind("}")
            if close < brace:
                errors.append(f"line {lineno}: unbalanced braces")
                continue
            labels = _parse_labels(rest[brace + 1:close], errors, lineno)
            if labels is None:
                continue
            tail = rest[close + 1:].split()
        else:
            fields = rest.split()
            name, labels, tail = fields[0], {}, fields[1:]
        if not _EXPO_NAME.match(name):
            errors.append(f"line {lineno}: bad metric name {name!r}")
            continue
        if not tail or len(tail) > 2:
            errors.append(f"line {lineno}: expected 'value [timestamp]'")
            continue
        if not _EXPO_VALUE.match(tail[0]):
            errors.append(f"line {lineno}: bad value {tail[0]!r}")
        if len(tail) == 2 and not re.match(r"-?\d+\Z", tail[1]):
            errors.append(f"line {lineno}: bad timestamp {tail[1]!r}")
        # family resolution: histogram samples append _bucket/_sum/_count
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) in ("histogram", "summary"):
                family = base
                if (suffix == "_bucket"
                        and types.get(base) == "histogram"
                        and "le" not in labels):
                    errors.append(
                        f"line {lineno}: histogram _bucket without "
                        "'le' label")
                break
        families_emitted.add(family)
        key = (name, tuple(sorted(labels.items())))
        if key in seen_samples:
            errors.append(
                f"line {lineno}: duplicate sample {name}{labels}")
        seen_samples.add(key)
        n_samples += 1
    if errors:
        raise ValueError(
            "invalid exposition:\n  " + "\n  ".join(errors))
    return n_samples


# ---------------------------------------------------------------- default
_default_registry = None          # so Metric.__init__ sees a name
_default_registry = Registry()


def default_registry():
    return _default_registry


def counter(name, help=""):
    return _default_registry.counter(name, help)


def gauge(name, help=""):
    return _default_registry.gauge(name, help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS,
              reservoir=DEFAULT_RESERVOIR):
    return _default_registry.histogram(name, help, buckets=buckets,
                                       reservoir=reservoir)


def value(name, /, **labels):
    return _default_registry.value(name, **labels)


def snapshot():
    return _default_registry.snapshot()


def render_prometheus():
    return _default_registry.render_prometheus()


def reset():
    _default_registry.reset()


def register_provider(name, provider):
    _default_registry.register_provider(name, provider)


def unregister_provider(name):
    _default_registry.unregister_provider(name)


def provider_counters():
    return _default_registry.provider_counters()
