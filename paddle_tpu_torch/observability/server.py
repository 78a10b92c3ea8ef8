"""Live telemetry endpoint: a stdlib ``http.server`` exporter on a
background thread (the port's copy of
``paddle_tpu/observability/server.py``).

This is the process's observability front door — the piece that turns
the in-process registry/event-ring/flight-recorder into something a
scraper, a load balancer, or a human with ``curl`` can reach while the
engine serves:

=================  ======================================================
path               payload
=================  ======================================================
``/metrics``       Prometheus text exposition (``render_prometheus()``)
``/healthz``       liveness — 200 the moment the thread serves
``/readyz``        readiness — 503 while the SLO tracker reports
                   unhealthy (multi-window burn), 200 otherwise; body
                   carries the per-objective burn snapshot either way
``/debug/requests``  flight-recorder JSON: all live + last-N finished
                   request traces
``/debug/slo``     full SLO tracker snapshot (objectives, windows,
                   compliance, burn rates)
``/trace``         chrome-trace JSON: process event ring merged with
                   per-request async spans (load in Perfetto)
``/``              tiny JSON index of the above
=================  ======================================================

The JAX server's ``/debug/programs``, ``/debug/comms``, ``/debug/mesh``
and ``/debug/fleet`` serve XLA program cards, the jaxpr comms ledger
and the fleet simulator, none of which the port has; they answer 404
here.

Deliberately stdlib-only (``ThreadingHTTPServer`` on a daemon thread,
no framework, no new dependency) and deliberately read-only: every
route is a GET over data structures that already exist. ``port=0``
binds an ephemeral port (``.port`` reports the real one) so tests and
multi-engine processes never collide. The server holds REFERENCES to
the registry / recorder / SLO tracker, not the engine — an engine owns
and stops its server (``EngineConfig(telemetry_port=...)``), but the
server can outlive or predate any engine.

Lifecycle: ``start()`` registers a ``telemetry.serverN`` provider on
its registry (the scrape endpoint is itself observable — up/port per
server); ``stop()`` unregisters it, shuts the listener down, and joins
the serving thread.  A server the owner forgets to stop still cleans
up at GC via ``weakref.finalize`` (the engine's provider pattern), so
repeated engine build/close cycles never accumulate stale providers.
"""

from __future__ import annotations

import json
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import events as _events
from . import metrics as _metrics

#: content type the Prometheus exposition format 0.0.4 mandates
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

ROUTES = ("/metrics", "/healthz", "/readyz", "/debug/requests",
          "/debug/slo", "/trace")


class TelemetryServer:
    """Background-thread HTTP exporter over the observability state.

    Parameters are all optional references: ``registry`` (default
    process registry), ``event_log`` (default process ring),
    ``recorder`` (a :class:`~.tracing.FlightRecorder`; without one
    ``/debug/requests`` serves an empty recorder view), ``slo`` (an
    :class:`~.slo.SLOTracker`; without one ``/readyz`` is always
    ready)."""

    def __init__(self, port=0, host="127.0.0.1", registry=None,
                 event_log=None, recorder=None, slo=None):
        self._host = host
        self._want_port = int(port)
        self.registry = registry
        self.event_log = event_log
        self.recorder = recorder
        self.slo = slo
        self._httpd = None
        self._thread = None
        self._provider_name = None
        self._finalizer = None

    # ------------------------------------------------------------ plumbing
    def _registry(self):
        return self.registry or _metrics.default_registry()

    def _event_log(self):
        return self.event_log or _events.default_log()

    # ----------------------------------------------------------- lifecycle
    @property
    def running(self):
        return self._httpd is not None

    @property
    def port(self):
        """The actually-bound port (meaningful after ``start()``)."""
        return self._httpd.server_address[1] if self._httpd else None

    def url(self, path="/"):
        return f"http://{self._host}:{self.port}{path}"

    _instances = 0

    def start(self):
        """Bind and serve on a daemon thread; idempotent.  Registers a
        ``telemetry.serverN`` counter provider on the registry (the
        endpoint itself is observable) and arms a ``weakref.finalize``
        so an un-stopped server still unregisters and closes its
        socket when garbage-collected."""
        if self._httpd is not None:
            return self
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self._host, self._want_port),
                                          handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"telemetry:{self.port}", daemon=True)
        self._thread.start()
        TelemetryServer._instances += 1
        self._provider_name = f"telemetry.server{TelemetryServer._instances}"
        reg = self._registry()
        # the provider must not pin the server (mirror the engine's
        # weakref provider): a dead/stopped server reports nothing
        ref = weakref.ref(self)

        def _provider():
            srv = ref()
            if srv is None or srv._httpd is None:
                return {}
            return {"up": 1, "port": srv.port}

        reg.register_provider(self._provider_name, _provider)
        self._finalizer = weakref.finalize(
            self, _finalize_server, self._httpd, reg, self._provider_name)
        _events.instant("telemetry.start", cat="observability",
                        port=self.port)
        return self

    def stop(self):
        """Unregister the metrics provider, shut down the listener, and
        join the serving thread; idempotent."""
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        if self._provider_name is not None:
            self._registry().unregister_provider(self._provider_name)
            self._provider_name = None
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
        _events.instant("telemetry.stop", cat="observability")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------ payloads
    def handle(self, path):
        """Route one GET; returns (status, content_type, body-bytes).
        Separated from the HTTP plumbing so tests can exercise routing
        without sockets."""
        path = path.split("?", 1)[0]
        if path == "/metrics":
            return 200, PROM_CONTENT_TYPE, self._registry(
                ).render_prometheus().encode()
        if path == "/healthz":
            return 200, "text/plain; charset=utf-8", b"ok\n"
        if path == "/readyz":
            ready = self.slo is None or self.slo.healthy
            body = {"ready": ready}
            if self.slo is not None:
                body["slo"] = self.slo.snapshot()
            return (200 if ready else 503), "application/json", _js(body)
        if path == "/debug/requests":
            payload = (self.recorder.to_json() if self.recorder is not None
                       else {"capacity": 0, "live_count": 0,
                             "finished_retained": 0, "finished_total": 0,
                             "dropped_finished": 0, "live": [],
                             "recent": []})
            return 200, "application/json", _js(payload)
        if path == "/debug/slo":
            payload = (self.slo.snapshot() if self.slo is not None
                       else {"tracker": None, "healthy": True,
                             "objectives": {}})
            return 200, "application/json", _js(payload)
        if path == "/trace":
            extra = (self.recorder.chrome_events()
                     if self.recorder is not None else None)
            text = self._event_log().export_chrome_trace(extra=extra)
            return 200, "application/json", text.encode()
        if path == "/":
            return 200, "application/json", _js(
                {"service": "paddle_tpu_torch.observability",
                 "endpoints": list(ROUTES)})
        return 404, "text/plain; charset=utf-8", b"not found\n"


def _js(obj):
    return (json.dumps(obj, indent=2, default=repr) + "\n").encode()


def _finalize_server(httpd, registry, provider_name):
    """GC fallback for a server that was never stop()ed: drop its
    provider and close the socket (must not reference the server —
    weakref.finalize callbacks that do would keep it alive forever)."""
    registry.unregister_provider(provider_name)
    try:
        httpd.shutdown()
        httpd.server_close()
    except Exception:                # pragma: no cover - interp exit
        pass


def _make_handler(server):
    # weakref, not a closure over the server: the serving thread holds
    # the httpd which holds this handler class — a strong ref here
    # would pin an abandoned server alive and its GC finalizer would
    # never fire
    ref = weakref.ref(server)

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            srv = ref()
            try:
                if srv is None:
                    raise RuntimeError("server shutting down")
                status, ctype, body = srv.handle(self.path)
            except Exception as e:  # never kill the serving thread
                status, ctype = 500, "text/plain; charset=utf-8"
                body = f"error: {type(e).__name__}: {e}\n".encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass  # scrapes are high-frequency; keep stderr quiet

    return _Handler

