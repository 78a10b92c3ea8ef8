"""Gateway protocol layer: the OpenAI-style HTTP/SSE front door (the
port's copy of ``paddle_tpu/serving/gateway/protocol.py``).

A stdlib ``ThreadingHTTPServer`` (the telemetry server's pattern — no
framework, no new dependency, ``port=0`` binds ephemeral) exposing:

=====================  ==================================================
route                  behavior
=====================  ==================================================
``POST /v1/completions``  OpenAI-style completion over token ids.
                       ``"stream": true`` answers ``text/event-stream``:
                       one ``data: {...}`` chunk per decode horizon the
                       request rode (the worker flushes token deltas as
                       the engine harvests them), a final chunk carrying
                       ``finish_reason``, then the ``data: [DONE]``
                       sentinel.  Non-streaming answers one JSON body
                       with the full ``token_ids`` and ``usage``.
``GET /v1/models``     the single served model, OpenAI list shape
``GET /healthz``       liveness — 200 while the listener serves
``GET /readyz``        readiness — 503 unless some replica is healthy
``GET /metrics``       Prometheus exposition of the process registry
                       (``gateway.*`` families included)
``GET /``              tiny JSON index
=====================  ==================================================

Errors are structured OpenAI-style bodies
(``{"error": {"message", "type", "code"}}``): **400** malformed/invalid
request, **404** unknown model or route, **429** tenant quota exhausted
(``Retry-After`` = seconds until the bucket refills enough), **503** +
``Retry-After`` while every replica is shedding (the SLO burn signal
``/readyz`` flips on) or draining.

The model serves token ids, not text — requests carry ``"prompt"`` as a
list of ints and responses carry ``"token_ids"`` per choice (an
optional ``detokenize`` callable on the config fills the OpenAI
``"text"`` field).  Request fields map 1:1 onto the engine's
``SamplingParams`` (``max_tokens`` -> ``max_new_tokens``,
``stop_token_id`` -> ``eos_token_id``) plus the gateway-era admission
fields ``priority``, ``deadline_s``, and ``tenant`` (OpenAI's ``user``
is accepted as an alias).  A NEGATIVE ``priority`` selects the offline
batch lane: normalized to one tier (-1), non-streaming only (400
``batch_no_stream`` with ``"stream": true``), preemptible, and exempt
from the scheduler's starvation window — interactive traffic passes
it without bound.  Because the engine's sampling is bitwise
deterministic per ``(seed, token index)``, a streamed completion is
token-for-token identical to in-process ``Engine.run()`` for the same
request — tested both greedy and seeded-stochastic.

Deliberately NOT built (out of scope for an in-process fleet front
door): TLS termination, authentication/authorization, multi-host
routing, request body compression.  Terminate TLS and authenticate in
front of this gateway.
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ...observability import metrics as _obs_metrics
from ...observability.server import PROM_CONTENT_TYPE
from ..engine import Engine
from ..faults import (_SRV_RETRIES, RetryPolicy, TransientSubmitError,
                      WorkerDeadError)
from ..sampling import SamplingParams
from ..scheduler import FINISH_EOS
from ..structured.grammar import GrammarError, GrammarSpec
from .admission import TenantQuotas
from .router import EngineWorker, FleetSupervisor, PrefixAffinityRouter

# gateway.* metric families (labels via kwargs, like serving.*)
_GW_REQS = _obs_metrics.counter(
    "gateway.requests", "HTTP requests handled, by route and status")
_GW_REJECTS = _obs_metrics.counter(
    "gateway.rejections",
    "completions rejected at admission (reason=invalid|model|quota|shed)")
_GW_ROUTED = _obs_metrics.counter(
    "gateway.routed", "sessions routed, by replica and affinity outcome")
_GW_STREAMS = _obs_metrics.counter(
    "gateway.streams", "SSE completion streams opened")
_GW_STREAM_TOKENS = _obs_metrics.counter(
    "gateway.stream_tokens", "tokens flushed over SSE streams")
_GW_TTFT = _obs_metrics.histogram(
    "gateway.ttft_seconds",
    "gateway receive to first streamed token chunk")
_GW_LATENCY = _obs_metrics.histogram(
    "gateway.request_seconds", "gateway receive to completion sent")
# the per-tenant ledger, promoted from stats() to scrapeable metrics:
# tokens mirror the engines' authoritative per-tenant accounting
# (republished at each completion), sheds count this gateway's
# admission rejections (quota + SLO shed + retry-budget) per tenant
_GW_TENANT_TOKENS = _obs_metrics.gauge(
    "gateway.tenant_tokens_served",
    "tokens generated per tenant across the fleet (engine ledger, "
    "republished at completion)")
_GW_TENANT_SHEDS = _obs_metrics.gauge(
    "gateway.tenant_sheds",
    "admission rejections per tenant (quota exhausted, SLO shed, "
    "retry budget spent)")

#: finish_reason wire mapping (OpenAI uses "stop" for EOS)
_FINISH_WIRE = {FINISH_EOS: "stop"}


@dataclass
class GatewayConfig:
    host: str = "127.0.0.1"
    #: 0 binds an ephemeral port (``gateway.port`` reports it)
    port: int = 0
    #: the id ``/v1/models`` advertises; requests naming another model
    #: get 404 model_not_found (absent/null model fields are accepted)
    model_id: str = "paddle-tpu"
    #: per-tenant token-bucket quota: a request costs
    #: ``prompt_tokens + max_tokens``.  None disables quota (no 429s).
    quota_tokens: float | None = None
    #: bucket refill rate; None defaults to ``quota_tokens`` per second
    quota_refill_per_s: float | None = None
    #: Retry-After seconds sent with 503 shed responses
    shed_retry_after_s: float = 1.0
    #: leading radix-cache blocks hashed into the routing affinity key
    affinity_blocks: int = 2
    #: interactive priorities are validated to [0, max_priority] (the
    #: scheduler's starvation bound is reorder_window *
    #: (1 + max_priority)).  NEGATIVE priorities are the offline batch
    #: lane: normalized to -1, non-streaming only, preemptible, and
    #: exempt from the starvation window (interactive traffic passes
    #: without bound)
    max_priority: int = 8
    #: ceiling on one completion's wall time before the gateway aborts
    #: it server-side
    request_timeout_s: float = 120.0
    #: worker watchdog: a replica holding work that hasn't heartbeat
    #: within this is condemned and its streams failed over (None
    #: disables stall detection; dead threads are always detected).
    #: Generous by default — a cold compile must never look like a hang.
    watchdog_timeout_s: float | None = 60.0
    #: how often the fleet supervisor sweeps worker health
    watchdog_interval_s: float = 0.25
    #: per-request budget of submit retries after transient failures;
    #: only a spent budget surfaces a 503 (with the next backoff delay
    #: as an honest Retry-After)
    retry_budget: int = 2
    #: capped-exponential retry backoff: base doubles per attempt up to
    #: the cap, scaled by deterministic (seeded) jitter
    retry_backoff_s: float = 0.05
    retry_backoff_cap_s: float = 1.0
    retry_seed: int = 0
    #: optional ``tokens -> str`` callable filling the OpenAI ``text``
    #: response field; None leaves ``text`` empty (ids only)
    detokenize: object = None


class _Reject(Exception):
    """A structured HTTP error: status + OpenAI-style error body."""

    def __init__(self, status, message, etype, code=None,
                 retry_after=None):
        super().__init__(message)
        self.status = status
        self.etype = etype
        self.code = code
        self.retry_after = retry_after

    def body(self):
        return {"error": {"message": str(self), "type": self.etype,
                          "code": self.code}}

    def headers(self):
        if self.retry_after is None:
            return {}
        # ceil so "retry after 0.3s" never rounds down to "now"
        return {"Retry-After": str(max(1, int(-(-self.retry_after))))}


class Gateway:
    """The HTTP front door over N in-process engine replicas.

    ``engines`` may be Engine instances (wrapped in
    :class:`EngineWorker` replicas named ``replica0..N-1``, owned and
    shut down by the gateway) or pre-built workers (caller-owned).
    ``quotas`` overrides the config-derived :class:`TenantQuotas`
    (tests inject a fake clock this way)."""

    def __init__(self, engines, config=None, quotas=None):
        self.config = config or GatewayConfig()
        if not engines:
            raise ValueError("gateway needs at least one engine")
        self._own_workers = isinstance(engines[0], Engine)
        self.workers = (
            [EngineWorker(e, name=f"replica{i}")
             for i, e in enumerate(engines)]
            if self._own_workers else list(engines))
        for w in self.workers:
            # workers keep an explicit watchdog timeout if the caller
            # set one; otherwise they inherit the gateway's
            if w.watchdog_timeout_s is None:
                w.watchdog_timeout_s = self.config.watchdog_timeout_s
        self.retry = RetryPolicy(
            max_retries=self.config.retry_budget,
            backoff_base_s=self.config.retry_backoff_s,
            backoff_cap_s=self.config.retry_backoff_cap_s,
            seed=self.config.retry_seed)
        self.router = PrefixAffinityRouter(
            self.workers, affinity_blocks=self.config.affinity_blocks,
            retry=self.retry)
        self.supervisor = FleetSupervisor(
            self.router,
            watchdog_timeout_s=self.config.watchdog_timeout_s,
            interval_s=self.config.watchdog_interval_s,
            retry=self.retry)
        self.quotas = quotas if quotas is not None else TenantQuotas(
            self.config.quota_tokens, self.config.quota_refill_per_s)
        self._httpd = None
        self._thread = None
        self._finalizer = None
        self._next_cmpl = 0
        self._cmpl_lock = threading.Lock()
        # gateway-side half of the per-tenant ledger: admission sheds
        # (the engines never see a shed request, so only the gateway
        # can bill it)
        self._tenant_sheds = {}
        self._shed_lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle
    @property
    def running(self):
        return self._httpd is not None

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    def url(self, path="/"):
        return f"http://{self.config.host}:{self.port}{path}"

    def start(self):
        """Bind and serve on a daemon thread; idempotent."""
        if self._httpd is not None:
            return self
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer(
            (self.config.host, int(self.config.port)), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"gateway:{self.port}", daemon=True)
        self._thread.start()
        self.supervisor.start()
        self._finalizer = weakref.finalize(self, _finalize_httpd,
                                           self._httpd)
        return self

    def stop(self):
        """Stop the HTTP listener (workers keep running); idempotent."""
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    def shutdown(self):
        """Full teardown: stop the listener and the supervisor, drain
        and stop every worker; engines the gateway wrapped itself are
        closed too.  A crashed/condemned replica cannot drain
        (``WorkerDeadError``) — its streams were already failed over,
        so teardown skips it rather than fail."""
        self.stop()
        self.supervisor.stop()
        for w in list(self.workers):
            try:
                w.drain()
            except WorkerDeadError:
                pass
            finally:
                w.stop()
            if self._own_workers:
                # ownership transferred: gateway-built engines, closed
                # only after drain() + stop() joined the worker thread
                w.engine.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # ------------------------------------------------------------- helpers
    def _cmpl_id(self):
        with self._cmpl_lock:
            self._next_cmpl += 1
            return f"cmpl-{self._next_cmpl}"

    def _text(self, token_ids):
        fn = self.config.detokenize
        return fn(token_ids) if fn is not None else ""

    @staticmethod
    def _wire_reason(reason):
        return _FINISH_WIRE.get(reason, reason)

    # ----------------------------------------------------- tenant ledger
    def _bill_shed(self, tenant):
        """Charge one admission rejection to a tenant and republish its
        ``gateway.tenant_sheds`` gauge."""
        tenant = tenant or ""
        with self._shed_lock:
            n = self._tenant_sheds.get(tenant, 0) + 1
            self._tenant_sheds[tenant] = n
        _GW_TENANT_SHEDS.set(n, tenant=tenant)

    def _publish_tenant_tokens(self, tenant):
        """Republish one tenant's fleet-wide generated-token total
        (the engines' authoritative ledger summed across replicas) as
        the ``gateway.tenant_tokens_served`` gauge."""
        tenant = tenant or ""
        total = 0
        for w in self.workers:
            eng = getattr(w, "engine", None)
            if eng is None:
                continue
            try:
                total += eng.tenant_ledger().get(tenant, {}).get(
                    "tokens_generated", 0)
            except Exception:
                continue     # a crashed replica has nothing to report
        _GW_TENANT_TOKENS.set(total, tenant=tenant)

    def tenant_ledger(self):
        """The fleet-wide per-tenant attainment ledger: the engines'
        per-tenant accounting summed across replicas, plus this
        gateway's admission-shed tally — the hook the fleet replay
        harness aggregates per-tenant attainment from (and the source
        of the ``gateway.tenant_*`` gauges on ``/metrics``)."""
        zero = {"submitted": 0, "finished": 0, "aborted": 0,
                "tokens_generated": 0, "sheds": 0}
        out = {}
        for w in self.workers:
            eng = getattr(w, "engine", None)
            if eng is None:
                continue
            try:
                ledger = eng.tenant_ledger()
            except Exception:
                continue
            for tenant, counts in ledger.items():
                agg = out.setdefault(tenant, dict(zero))
                for k, v in counts.items():
                    agg[k] = agg.get(k, 0) + v
        with self._shed_lock:
            sheds = dict(self._tenant_sheds)
        for tenant, n in sheds.items():
            out.setdefault(tenant, dict(zero))["sheds"] = n
        return out

    # ------------------------------------------------------------ GET side
    def handle_get(self, path):
        """Route one GET; returns (status, content_type, body bytes).
        Socket-free (tests call it directly)."""
        path = path.split("?", 1)[0]
        if path == "/v1/models":
            return 200, "application/json", _js(
                {"object": "list",
                 "data": [{"id": self.config.model_id,
                           "object": "model",
                           "owned_by": "paddle_tpu_torch.serving"}]})
        if path == "/healthz":
            return 200, "text/plain; charset=utf-8", b"ok\n"
        if path == "/readyz":
            replicas = {w.name: {"healthy": w.healthy,
                                 "draining": w.draining,
                                 "load": w.load}
                        for w in self.workers}
            ready = any(r["healthy"] for r in replicas.values())
            return ((200 if ready else 503), "application/json",
                    _js({"ready": ready, "replicas": replicas}))
        if path == "/metrics":
            return (200, PROM_CONTENT_TYPE,
                    _obs_metrics.render_prometheus().encode())
        if path == "/":
            return 200, "application/json", _js(
                {"service": "paddle_tpu_torch.serving.gateway",
                 "endpoints": ["/v1/completions", "/v1/models",
                               "/healthz", "/readyz", "/metrics"]})
        return 404, "application/json", _js(
            {"error": {"message": f"unknown route {path}",
                       "type": "invalid_request_error",
                       "code": "route_not_found"}})

    # ----------------------------------------------------- completion path
    def parse_completion(self, payload):
        """Validate a /v1/completions body into the engine-facing
        request dict; raises :class:`_Reject` (400/404) on anything
        malformed.  Unknown fields are ignored (OpenAI-compatible)."""
        def bad(msg, code=None):
            return _Reject(400, msg, "invalid_request_error", code)

        if not isinstance(payload, dict):
            raise bad("request body must be a JSON object")
        model = payload.get("model")
        if model is not None and model != self.config.model_id:
            raise _Reject(
                404, f"model {model!r} not found (serving "
                f"{self.config.model_id!r})", "invalid_request_error",
                "model_not_found")
        prompt = payload.get("prompt")
        if (not isinstance(prompt, (list, tuple)) or not prompt
                or not all(isinstance(t, int)
                           and not isinstance(t, bool) for t in prompt)):
            raise bad("'prompt' must be a non-empty list of token ids "
                      "(ints) — this gateway serves token ids, not text")
        sp = {}
        for wire, field, typ in (
                ("max_tokens", "max_new_tokens", int),
                ("temperature", "temperature", float),
                ("top_k", "top_k", int),
                ("top_p", "top_p", float),
                ("seed", "seed", int),
                ("stop_token_id", "eos_token_id", int),
                ("eos_token_id", "eos_token_id", int)):
            v = payload.get(wire)
            if v is None:
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise bad(f"'{wire}' must be a number")
            sp[field] = typ(v)
        try:
            sampling = SamplingParams(**sp).validate()
        except ValueError as e:
            raise bad(str(e)) from None
        priority = payload.get("priority", 0)
        if (isinstance(priority, bool) or not isinstance(priority, int)
                or priority > self.config.max_priority):
            raise bad(f"'priority' must be an int <= "
                      f"{self.config.max_priority} (negative = the "
                      f"offline batch lane)")
        if priority < 0:
            # the offline batch lane is one tier: lowest, non-streaming,
            # preemptible, overtaken without bound
            priority = -1
            if payload.get("stream"):
                raise bad("batch-lane requests (priority < 0) cannot "
                          "stream: the lane is preemptible and "
                          "non-interactive — poll the JSON completion "
                          "instead", "batch_no_stream")
        deadline = payload.get("deadline_s")
        if deadline is not None and (
                isinstance(deadline, bool)
                or not isinstance(deadline, (int, float))
                or not deadline > 0):
            raise bad("'deadline_s' must be a positive number")
        tenant = payload.get("tenant", payload.get("user", ""))
        if not isinstance(tenant, str):
            raise bad("'tenant' must be a string")
        stream = payload.get("stream", False)
        if not isinstance(stream, bool):
            raise bad("'stream' must be a boolean")
        # structured generation: OpenAI ``response_format`` (json_schema)
        # or the ``grammar`` extension (regex).  Validation is EAGER —
        # an unsupported grammar 400s HERE (code ``invalid_grammar``,
        # message naming the feature), before anything queues.
        grammar = None
        rf = payload.get("response_format")
        if rf is not None:
            if not isinstance(rf, dict) or not isinstance(
                    rf.get("type"), str):
                raise bad("'response_format' must be an object with a "
                          "string 'type'", "invalid_grammar")
            kind = rf["type"]
            if kind == "json_schema":
                js = rf.get("json_schema")
                if not isinstance(js, dict):
                    raise bad("'response_format.json_schema' must be an "
                              "object", "invalid_grammar")
                # OpenAI nests the schema under "schema"; a bare schema
                # object is accepted too
                schema = js.get("schema", js) if "schema" in js else js
                if not isinstance(schema, dict):
                    raise bad("'response_format.json_schema.schema' "
                              "must be a JSON-schema object",
                              "invalid_grammar")
                try:
                    grammar = GrammarSpec.json_schema(schema)
                except GrammarError as e:
                    raise bad(str(e), "invalid_grammar") from None
            elif kind != "text":
                raise bad(
                    f"unsupported response_format type {kind!r} "
                    "(supported: 'text', 'json_schema')",
                    "invalid_grammar")
        gr = payload.get("grammar")
        if gr is not None:
            if grammar is not None:
                raise bad("'grammar' and a json_schema "
                          "'response_format' are mutually exclusive",
                          "invalid_grammar")
            if isinstance(gr, str):
                pattern = gr
            elif (isinstance(gr, dict) and gr.get("type") == "regex"
                    and isinstance(gr.get("pattern"), str)):
                pattern = gr["pattern"]
            else:
                raise bad("'grammar' must be a regex string or "
                          "{'type': 'regex', 'pattern': '...'}",
                          "invalid_grammar")
            try:
                grammar = GrammarSpec.regex(pattern)
            except GrammarError as e:
                raise bad(str(e), "invalid_grammar") from None
        if grammar is not None and sampling.eos_token_id is None:
            raise bad("grammar-constrained requests require "
                      "'eos_token_id' (or 'stop_token_id'): EOS is "
                      "legal exactly in the grammar's accept states",
                      "invalid_grammar")
        return {"prompt_ids": list(prompt), "sampling": sampling,
                "priority": priority, "deadline_s": deadline,
                "tenant": tenant, "stream": stream, "grammar": grammar}

    def admit_and_route(self, parsed, t_recv):
        """Quota gate then replica routing; returns a submitted
        :class:`StreamHandle`.  Raises :class:`_Reject` with 429
        (quota), 503 (every replica shedding/draining, or the retry
        budget spent on transient submit failures — Retry-After then
        carries the NEXT backoff delay, the honest answer), or 400
        (engine-side validation, e.g. prompt+budget over max_seq_len).
        Transient submit failures (and a replica dying between route
        and submit) are retried up to ``retry_budget`` times with
        capped exponential backoff and deterministic jitter,
        re-routing every attempt."""
        cost = (len(parsed["prompt_ids"])
                + parsed["sampling"].max_new_tokens)
        granted, retry = self.quotas.admit(parsed["tenant"], cost)
        if not granted:
            _GW_REJECTS.inc(reason="quota")
            self._bill_shed(parsed["tenant"])
            raise _Reject(
                429, f"tenant {parsed['tenant']!r} quota exhausted "
                f"({cost} tokens requested)", "tenant_quota_exceeded",
                "quota_exhausted", retry_after=retry)
        ordinal = self.router.next_ordinal()
        attempt = 0
        while True:
            worker, how = self.router.route(parsed["prompt_ids"])
            if worker is None:
                _GW_REJECTS.inc(reason="shed")
                self._bill_shed(parsed["tenant"])
                raise _Reject(
                    503, "every replica is unhealthy (SLO burn) or "
                    "draining; retry shortly", "service_unavailable",
                    "slo_shedding",
                    retry_after=self.config.shed_retry_after_s)
            try:
                handle = worker.submit(
                    parsed["prompt_ids"], sampling=parsed["sampling"],
                    priority=parsed["priority"],
                    deadline_s=parsed["deadline_s"],
                    tenant=parsed["tenant"],
                    grammar=parsed.get("grammar"),
                    trace_args={"tenant": parsed["tenant"],
                                "priority": parsed["priority"],
                                "hop_s": round(
                                    time.monotonic() - t_recv, 6)})
            except ValueError as e:
                _GW_REJECTS.inc(reason="invalid")
                raise _Reject(400, str(e),
                              "invalid_request_error") from None
            except (TransientSubmitError, WorkerDeadError,
                    TimeoutError) as e:
                if attempt >= self.retry.max_retries:
                    _GW_REJECTS.inc(reason="retry_budget")
                    self._bill_shed(parsed["tenant"])
                    raise _Reject(
                        503, f"submit failed after {attempt + 1} "
                        f"attempts: {e}", "service_unavailable",
                        "retry_budget_exhausted",
                        retry_after=self.retry.delay(
                            ordinal, attempt + 1)) from None
                _SRV_RETRIES.inc(replica=worker.name)
                time.sleep(self.retry.delay(ordinal, attempt))
                attempt += 1
                continue
            except RuntimeError as e:
                _GW_REJECTS.inc(reason="shed")
                self._bill_shed(parsed["tenant"])
                raise _Reject(
                    503, str(e), "service_unavailable",
                    "replica_draining",
                    retry_after=self.config.shed_retry_after_s) \
                    from None
            break
        _GW_ROUTED.inc(replica=worker.name, affinity=how)
        return handle

    def _chunk(self, cmpl_id, created, token_ids, reason=None):
        return {"id": cmpl_id, "object": "text_completion.chunk",
                "created": created, "model": self.config.model_id,
                "choices": [{"index": 0, "token_ids": token_ids,
                             "text": self._text(token_ids),
                             "finish_reason": reason}]}

    def sse_events(self, handle, t_recv):
        """Generator of SSE frames (bytes) for one streaming
        completion: one ``data:`` frame per harvested token chunk, a
        final frame carrying ``finish_reason``, then ``data: [DONE]``.
        Timeout aborts the request server-side and surfaces as
        ``finish_reason: "abort"`` — the stream always terminates."""
        cmpl_id = self._cmpl_id()
        created = int(time.time())
        deadline = t_recv + self.config.request_timeout_s
        _GW_STREAMS.inc()
        first = True
        while True:
            try:
                kind, value = handle.events.get(
                    timeout=max(0.05, deadline - time.monotonic()))
            except Exception:
                handle.worker.abort(handle, cause="gateway_timeout")
                kind, value = handle.events.get(timeout=30.0)
                while kind != "finish":      # drain to the terminal
                    kind, value = handle.events.get(timeout=30.0)
            if kind == "tokens":
                if first:
                    _GW_TTFT.observe(time.monotonic() - t_recv)
                    first = False
                _GW_STREAM_TOKENS.inc(len(value))
                yield _sse(self._chunk(cmpl_id, created, value))
            else:
                yield _sse(self._chunk(cmpl_id, created, [],
                                       self._wire_reason(value)))
                yield b"data: [DONE]\n\n"
                _GW_LATENCY.observe(time.monotonic() - t_recv)
                self._publish_tenant_tokens(handle.request.tenant)
                return

    def complete_sync(self, handle, t_recv):
        """Blocking non-streaming completion: wait for the terminal
        event, answer one JSON body."""
        deadline = t_recv + self.config.request_timeout_s
        while True:
            try:
                kind, value = handle.events.get(
                    timeout=max(0.05, deadline - time.monotonic()))
            except Exception:
                handle.worker.abort(handle, cause="gateway_timeout")
                continue
            if kind == "finish":
                break
        req = handle.request
        _GW_LATENCY.observe(time.monotonic() - t_recv)
        self._publish_tenant_tokens(req.tenant)
        return {
            "id": self._cmpl_id(), "object": "text_completion",
            "created": int(time.time()),
            "model": self.config.model_id,
            "choices": [{"index": 0,
                         "token_ids": list(req.output_ids),
                         "text": self._text(req.output_ids),
                         "finish_reason": self._wire_reason(value)}],
            "usage": {"prompt_tokens": req.prompt_len,
                      "completion_tokens": req.n_generated,
                      "total_tokens": (req.prompt_len
                                       + req.n_generated)}}


def _js(obj):
    return (json.dumps(obj, indent=2, default=repr) + "\n").encode()


def _sse(obj):
    """One SSE frame: ``data: <json>`` terminated by a blank line."""
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


def _finalize_httpd(httpd):
    try:
        httpd.shutdown()
        httpd.server_close()
    except Exception:                    # pragma: no cover - interp exit
        pass


def _make_handler(gateway):
    # weakref (the telemetry server's pattern): the serving thread holds
    # the httpd which holds this class — a strong ref would pin an
    # abandoned gateway and its engines alive forever
    ref = weakref.ref(gateway)

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _respond(self, status, ctype, body, headers=None):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            gw = ref()
            route = self.path.split("?", 1)[0]
            try:
                if gw is None:
                    raise RuntimeError("gateway shutting down")
                status, ctype, body = gw.handle_get(self.path)
            except Exception as e:   # never kill the serving thread
                status, ctype = 500, "application/json"
                body = _js({"error": {
                    "message": f"{type(e).__name__}: {e}",
                    "type": "internal_error", "code": None}})
            _GW_REQS.inc(route=route, code=str(status))
            self._respond(status, ctype, body)

        def do_POST(self):
            gw = ref()
            t_recv = time.monotonic()
            route = self.path.split("?", 1)[0]
            status = 500
            try:
                if gw is None:
                    raise RuntimeError("gateway shutting down")
                if route != "/v1/completions":
                    raise _Reject(404, f"unknown route {route}",
                                  "invalid_request_error",
                                  "route_not_found")
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(
                        self.rfile.read(length).decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    _GW_REJECTS.inc(reason="invalid")
                    raise _Reject(400, "request body is not valid JSON",
                                  "invalid_request_error") from None
                parsed = gw.parse_completion(payload)
                handle = gw.admit_and_route(parsed, t_recv)
                if parsed["stream"]:
                    status = 200
                    _GW_REQS.inc(route=route, code="200")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/event-stream; charset=utf-8")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.close_connection = True
                    self.end_headers()
                    try:
                        for frame in gw.sse_events(handle, t_recv):
                            self.wfile.write(frame)
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        handle.worker.abort(handle)
                    return
                status = 200
                body = _js(gw.complete_sync(handle, t_recv))
                _GW_REQS.inc(route=route, code="200")
                self._respond(200, "application/json", body)
            except _Reject as e:
                status = e.status
                _GW_REQS.inc(route=route, code=str(status))
                self._respond(status, "application/json", _js(e.body()),
                              headers=e.headers())
            except Exception as e:   # never kill the serving thread
                _GW_REQS.inc(route=route, code=str(status))
                self._respond(500, "application/json", _js(
                    {"error": {"message": f"{type(e).__name__}: {e}",
                               "type": "internal_error", "code": None}}))

        def log_message(self, fmt, *args):
            pass                     # high-frequency; keep stderr quiet

    return _Handler
