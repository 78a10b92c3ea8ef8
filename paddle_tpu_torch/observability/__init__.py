"""paddle_tpu_torch.observability — metrics, the structured event
timeline, request flight records, SLO tracking and the telemetry HTTP
endpoint: the port's copy of the host half of
``paddle_tpu/observability`` (stdlib and numpy; nothing here touches a
device tensor, so engine worker threads and HTTP threads share it).

* :mod:`.metrics` — typed Counter / Gauge / Histogram registry with
  label sets; ``snapshot()`` and ``render_prometheus()``; counter
  providers; ``validate_exposition``.
* :mod:`.events` — bounded ring-buffer event log with chrome-trace
  export.
* :mod:`.span` — ``span(name, **labels)``: a ``torch.profiler``
  ``record_function`` range, a histogram observation and a begin/end
  timeline pair.
* :mod:`.tracing` — per-request :class:`RequestTrace` flight records
  in a bounded :class:`FlightRecorder`.
* :mod:`.slo` — declared objectives over observation-count windows;
  compliance, multi-window burn rate, ``healthy``.
* :mod:`.server` — stdlib HTTP exporter (``/metrics``, ``/healthz``,
  ``/readyz``, ``/debug/requests``, ``/debug/slo``, ``/trace``).
* :mod:`.memory` — the device-memory ledger (components reconciled
  against ``torch.cuda.memory_allocated``) and the host->device
  bandwidth probe of the host KV tier's swap policy.

Not ported: ``profiling`` (XLA program cards, and with them the
ledger's roofline gauges), ``comms`` (a jaxpr walker), ``regression``,
``loadgen``, ``fleetsim`` and the CLI.
"""

from . import events, memory, metrics, slo, tracing
from .events import export_chrome_trace
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    default_registry,
    gauge,
    histogram,
    render_prometheus,
    snapshot,
    validate_exposition,
    value,
)
from .server import TelemetryServer
from .slo import Objective, SLOTracker
from .span import current_span, span, span_depth
from .tracing import FlightRecorder, RequestTrace

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "histogram", "value",
    "default_registry", "snapshot", "render_prometheus",
    "validate_exposition",
    "events", "metrics", "span", "current_span", "span_depth",
    "export_chrome_trace", "reset",
    "slo", "tracing",
    "RequestTrace", "FlightRecorder", "Objective", "SLOTracker",
    "TelemetryServer",
]


def reset():
    """Clear every metric value AND the event timeline (test isolation)."""
    metrics.reset()
    events.clear()
