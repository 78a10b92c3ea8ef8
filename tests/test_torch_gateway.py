"""The port's serving gateway (``paddle_tpu_torch.serving.gateway``) live
on the CPU: an HTTP/SSE front door over two port engines that share one
model, whose greedy streams equal the JAX engine's ``generate`` on the
same weights and whose seeded streams equal the port's own in-process
run; the OpenAI-style errors, quotas (429), SLO shedding (503), the
``invalid_grammar`` 400, ``/metrics``; and mid-stream failover (an
injected crash, greedy and seeded, and a watchdog-condemned stall),
bitwise, with nothing leaked after drain.  Exact throughout: every
compared quantity is a token id, a status or a count.  Every wait
carries its own bound (socket and queue timeouts, ports of 0)."""

import http.client
import json
import queue
import threading
import time

import pytest

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.gateway import TokenBucket as JTokenBucket
from paddle_tpu_torch.observability.metrics import validate_exposition
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving.faults import (
    FAULT_CRASH, FAULT_STALL, SITE_WORKER_DISPATCH, FaultInjector,
    FaultPlan, FaultSpec, RetryPolicy,
)
from paddle_tpu_torch.serving.gateway import (
    EngineWorker, FleetSupervisor, Gateway, GatewayConfig,
    PrefixAffinityRouter, TenantQuotas, TokenBucket,
)

from _torch_port_util import (  # noqa: F401
    TINY, jax_model, one_thread, port_model,
)

# a prompt shorter than one block (least-loaded routing) and two with
# an affinity key
PROMPTS = [[3, 1, 4, 1, 5, 9, 2],
           list(range(1, 21)),
           [7] * 16 + [11, 12, 13, 14, 15]]
NEW = 12
SEEDED = dict(temperature=0.8, top_k=24, top_p=0.95, seed=7)


def _cfg(**kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("max_horizon", 4)
    return EngineConfig(**kw)


@pytest.fixture(scope="module")
def weights():
    """The JAX model, the port's copy, and the JAX engine's greedy
    streams of every prompt (NEW tokens)."""
    jm = jax_model(TINY, seed=0)
    jeng = JEngine(jm, JEngineConfig(num_slots=4, max_seq_len=64,
                                     max_horizon=4),
                   register_profiler=False)
    greedy = [[int(t) for t in s] for s in jeng.generate(
        PROMPTS, JSamplingParams(max_new_tokens=NEW))]
    jeng.close()
    return jm, port_model(TINY, jm), greedy


@pytest.fixture(scope="module")
def seeded_ref(weights):
    """The port's in-process seeded streams (the port samples from torch
    generators keyed by (seed, token index), not threefry, so sampled
    streams are held against the port itself)."""
    eng = Engine(weights[1], _cfg(), device="cpu", register_profiler=False)
    out = [[int(t) for t in s] for s in eng.generate(
        PROMPTS, SamplingParams(max_new_tokens=NEW, **SEEDED))]
    eng.close()
    return out


@pytest.fixture(scope="module")
def gw(weights):
    """A live gateway over two engines on ONE model object (one copy of
    the weights, a pool and prefix store each)."""
    engines = [Engine(weights[1], _cfg(), device="cpu") for _ in range(2)]
    g = Gateway(engines, GatewayConfig(model_id="tiny")).start()
    yield g
    g.shutdown()
    for e in engines:
        assert e.pool.blocks_in_use == 0


class _Reply:
    """One HTTP answer, read whole (the connection is closed)."""

    def __init__(self, r):
        self.status, self.body = r.status, r.read()
        self.headers = dict(r.getheaders())

    def getheader(self, name):
        return self.headers.get(name)


def _post(port, payload, timeout=60):
    """POST /v1/completions (``payload`` a dict, or raw text) on a fresh
    connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions",
                     payload if isinstance(payload, str)
                     else json.dumps(payload),
                     {"Content-Type": "application/json"})
        return _Reply(conn.getresponse())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _parse_sse(raw):
    """(tokens, finish_reason) of an SSE body, checking the wire format:
    ``data: <json>`` frames, exactly one finish_reason on the last
    chunk, then ``data: [DONE]``."""
    frames = raw.split("\n\n")
    assert frames[-1] == ""
    frames = frames[:-1]
    assert frames and all(f.startswith("data: ") for f in frames)
    assert frames[-1] == "data: [DONE]"
    chunks = [json.loads(f[len("data: "):]) for f in frames[:-1]]
    reasons = [c["choices"][0]["finish_reason"] for c in chunks]
    assert all(r is None for r in reasons[:-1]) and reasons[-1]
    assert all(c["object"] == "text_completion.chunk" for c in chunks)
    return [t for c in chunks for t in c["choices"][0]["token_ids"]], \
        reasons[-1]


def _stream(port, prompt, **extra):
    r = _post(port, dict(extra, prompt=prompt, max_tokens=NEW,
                         stream=True))
    assert r.status == 200
    assert r.getheader("Content-Type").startswith("text/event-stream")
    return _parse_sse(r.body.decode())


# ------------------------------------------------------------ HTTP routes
def test_models_health_readiness_and_unknown_route(gw):
    status, body = _get(gw.port, "/v1/models")
    assert status == 200 and json.loads(body)["data"][0]["id"] == "tiny"
    assert _get(gw.port, "/healthz") == (200, b"ok\n")
    status, body = _get(gw.port, "/readyz")
    doc = json.loads(body)
    assert status == 200 and doc["ready"]
    assert sorted(doc["replicas"]) == ["replica0", "replica1"]
    status, body = _get(gw.port, "/nope")
    assert status == 404
    assert json.loads(body)["error"]["code"] == "route_not_found"


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_greedy_sse_stream_is_the_jax_engines_generate(gw, weights, i):
    toks, reason = _stream(gw.port, PROMPTS[i])
    assert toks == weights[2][i] and reason == "length"


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_seeded_sse_stream_is_the_in_process_run(gw, seeded_ref, i):
    toks, reason = _stream(gw.port, PROMPTS[i], **SEEDED)
    assert toks == seeded_ref[i] and reason == "length"


def test_concurrent_streams_from_client_threads(gw, weights, seeded_ref):
    """Six streams at once (greedy and seeded over every prompt), spread
    over both replicas: each equals its reference."""
    jobs = [(i, s) for i in range(len(PROMPTS)) for s in (False, True)]
    out = queue.Queue()

    def client(i, seeded):
        try:
            out.put((i, seeded, _stream(gw.port, PROMPTS[i],
                                        **(SEEDED if seeded else {}))))
        except Exception as e:               # surfaced below
            out.put((i, seeded, e))

    threads = [threading.Thread(target=client, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    got = [out.get(timeout=5) for _ in jobs]
    for i, seeded, res in got:
        assert not isinstance(res, Exception), res
        want = seeded_ref[i] if seeded else weights[2][i]
        assert res == (want, "length"), (i, seeded)


def test_sync_completion_shape_usage_and_tokens(gw, weights):
    r = _post(gw.port, {"model": "tiny", "prompt": PROMPTS[1],
                        "max_tokens": NEW, "tenant": "acme"})
    doc = json.loads(r.body)
    assert r.status == 200 and doc["object"] == "text_completion"
    choice = doc["choices"][0]
    assert choice["token_ids"] == weights[2][1]
    assert choice["finish_reason"] == "length"
    assert doc["usage"] == {"prompt_tokens": 20, "completion_tokens": NEW,
                            "total_tokens": 20 + NEW}
    assert gw.tenant_ledger()["acme"]["tokens_generated"] >= NEW


@pytest.mark.parametrize("payload,status,code", [
    ({"prompt": "text"}, 400, None),
    ({"prompt": []}, 400, None),
    ({"prompt": [1, 2.5]}, 400, None),
    ({"prompt": [1, True]}, 400, None),
    ({"prompt": [1, 2], "model": "other"}, 404, "model_not_found"),
    ({"prompt": [1, 2], "top_p": 0.0}, 400, None),
    ({"prompt": [1, 2], "max_tokens": "many"}, 400, None),
    ({"prompt": [1, 2], "priority": 99}, 400, None),
    ({"prompt": [1, 2], "priority": "high"}, 400, None),
    ({"prompt": [1, 2], "priority": -1, "stream": True}, 400,
     "batch_no_stream"),
    ({"prompt": [1, 2], "deadline_s": 0}, 400, None),
    ({"prompt": [1, 2], "tenant": 5}, 400, None),
    ({"prompt": [1, 2], "stream": "yes"}, 400, None),
    ({"prompt": [1] * 100, "max_tokens": 10}, 400, None),
    # a constrained request without an EOS id, and a response_format
    # that is not an object: the JAX gateway's invalid_grammar
    ({"prompt": [1, 2], "grammar": "[0-9]+"}, 400, "invalid_grammar"),
    ({"prompt": [1, 2], "response_format": {
        "type": "json_schema", "json_schema": {"schema": {
            "type": "object"}}}}, 400, "invalid_grammar"),
    ({"prompt": [1, 2], "response_format": "json"}, 400,
     "invalid_grammar"),
], ids=lambda v: str(v)[:40])
def test_validation_errors(gw, payload, status, code):
    r = _post(gw.port, payload)
    err = json.loads(r.body)["error"]
    assert r.status == status, err
    assert err["code"] == code
    assert err["message"]


def test_text_response_format_and_bad_json_body(gw):
    r = _post(gw.port, {"prompt": [1, 2, 3], "max_tokens": 2,
                        "response_format": {"type": "text"}})
    assert r.status == 200 and len(
        json.loads(r.body)["choices"][0]["token_ids"]) == 2
    assert _post(gw.port, "{not json").status == 400


def test_metrics_exposition_families(gw):
    _stream(gw.port, [1, 2, 3, 4])
    status, body = _get(gw.port, "/metrics")
    text = body.decode()
    assert status == 200
    assert validate_exposition(text) > 0
    for fam in ("gateway_requests", "gateway_streams",
                "gateway_stream_tokens", "gateway_routed",
                "gateway_ttft_seconds", "gateway_request_seconds",
                "gateway_tenant_tokens_served", "serving_tokens_generated",
                "serving_decode_steps", "serving_ttft_seconds",
                "serving_kv_blocks_in_use"):
        assert fam in text, fam
    name = gw.workers[0].engine._profiler_name
    assert f'engine="{name}"' in text


# -------------------------------------------------------------- admission
def test_token_bucket_is_the_jax_bucket():
    now = [0.0]
    b, jb = (cls(100, 10, clock=lambda: now[0])
             for cls in (TokenBucket, JTokenBucket))
    for take, dt in ((60, 0), (60, 0), (60, 2.0), (500, 0), (5, 30)):
        now[0] += dt
        assert b.try_take(take) == jb.try_take(take)
        assert b.available == jb.available


def test_quota_429_then_refill(weights):
    now = [0.0]
    quotas = TenantQuotas(40, 10, clock=lambda: now[0])
    eng = Engine(weights[1], _cfg(), device="cpu")
    gw = Gateway([eng], GatewayConfig(), quotas=quotas).start()
    try:
        body = {"prompt": [1] * 10, "max_tokens": 20, "tenant": "acme"}
        ok = _post(gw.port, body)
        assert ok.status == 200              # cost 30 <= 40
        denied = _post(gw.port, body)
        err = json.loads(denied.body)["error"]
        assert denied.status == 429
        assert err["type"] == "tenant_quota_exceeded"
        assert err["code"] == "quota_exhausted"
        assert int(denied.getheader("Retry-After")) >= 2   # 20 tokens
        other = _post(gw.port, dict(body, tenant="other"))
        assert other.status == 200
        now[0] += 3.0                        # refills 30 tokens
        again = _post(gw.port, body)
        assert again.status == 200
        assert gw.tenant_ledger()["acme"]["sheds"] == 1
    finally:
        gw.shutdown()
    assert eng.pool.blocks_in_use == 0


def test_slo_burn_sheds_503_with_retry_after(weights):
    eng = Engine(weights[1], _cfg(slo_ttft_s=1e-9, slo_fast_window=4,
                                  slo_slow_window=4), device="cpu")
    gw = Gateway([eng], GatewayConfig(shed_retry_after_s=2.0)).start()
    try:
        assert eng.slo.healthy
        for _ in range(8):                   # burn both windows
            eng.slo.observe("ttft", 1.0)
        assert _get(gw.port, "/readyz")[0] == 503
        r = _post(gw.port, {"prompt": [1, 2, 3], "max_tokens": 2})
        err = json.loads(r.body)["error"]
        assert r.status == 503 and err["code"] == "slo_shedding"
        assert r.getheader("Retry-After") == "2"
        for _ in range(8):                   # recover
            eng.slo.observe("ttft", 0.0)
        r = _post(gw.port, {"prompt": [1, 2, 3], "max_tokens": 2})
        assert r.status == 200
    finally:
        gw.shutdown()


def test_expired_deadline_finishes_abort(weights):
    """One slot busy with a long request: a queued request whose
    deadline passes before a slot frees finishes "abort"."""
    eng = Engine(weights[1], _cfg(num_slots=1), device="cpu")
    gw = Gateway([eng], GatewayConfig()).start()
    try:
        out = queue.Queue()
        hold = threading.Thread(target=lambda: out.put(_post(
            gw.port, {"prompt": [5] * 8, "max_tokens": 40}).body))
        hold.start()
        deadline = time.monotonic() + 30
        while not eng.scheduler.running and time.monotonic() < deadline:
            time.sleep(0.001)
        r = _post(gw.port, {"prompt": [1, 2, 3], "max_tokens": 4,
                            "deadline_s": 1e-6})
        doc = json.loads(r.body)
        assert r.status == 200
        assert doc["choices"][0]["finish_reason"] == "abort"
        hold.join(timeout=60)
        assert not hold.is_alive() and out.get(timeout=5)
        assert eng.counters()["deadline_expired"] == 1
    finally:
        gw.shutdown()


# ---------------------------------------------------------------- failover
FAIL_PROMPT = list(range(1, 9))


def _drain_handle(h, timeout=60.0):
    got, deadline = [], time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            kind, val = h.events.get(timeout=0.5)
        except queue.Empty:
            continue
        if kind == "tokens":
            got.extend(val)
        else:
            return got, val
    raise TimeoutError(f"stream {h.request_id} did not finish")


def _fleet(model):
    workers = [EngineWorker(Engine(model, _cfg(), device="cpu",
                                   register_profiler=False), name=f"r{i}")
               for i in range(2)]
    return workers, PrefixAffinityRouter(workers, retry=RetryPolicy())


def _shutdown(workers, sup):
    sup.stop()
    for w in workers:
        w.stop()


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_mid_stream_crash_fails_over_bitwise(weights, seeded):
    """A crash at the target replica's third dispatch: the supervisor
    condemns it and the other replica adopts the stream from the tokens
    already flushed; the stream equals the uninterrupted run, the seam
    is in the adopting engine's flight record, nothing leaks."""
    sp = SamplingParams(max_new_tokens=24, **(SEEDED if seeded else {}))
    ref = Engine(weights[1], _cfg(), device="cpu", register_profiler=False
                 ).generate(FAIL_PROMPT, sp)
    if not seeded:
        jeng = JEngine(weights[0], JEngineConfig(num_slots=4,
                                                 max_seq_len=64,
                                                 max_horizon=4),
                       register_profiler=False)
        assert ref == [int(t) for t in jeng.generate(
            FAIL_PROMPT, JSamplingParams(max_new_tokens=24))]
    workers, router = _fleet(weights[1])
    sup = FleetSupervisor(router, watchdog_timeout_s=None, interval_s=0.02)
    try:
        target, _ = router.route(FAIL_PROMPT)
        inj = FaultInjector(FaultPlan([
            FaultSpec(SITE_WORKER_DISPATCH, FAULT_CRASH, at=2)]))
        target.set_faults(inj)
        sup.start()
        h, w0, _ = router.submit(FAIL_PROMPT, sampling=sp)
        assert w0 is target
        got, fin = _drain_handle(h)
        assert (got, fin) == (ref, "length")
        assert h.failovers == 1 and h.worker is not target
        assert sup.stats() == {"failovers": 1, "failover_failures": 0,
                               "condemned": [(target.name, "crash")]}
        assert inj.counts() == {FAULT_CRASH: 1}
        c = h.request.trace.counts()
        assert c["failovers"] == 1
        assert 0 < c["resumed_tokens"] < len(ref)
        assert c["resumed_tokens"] + c["tokens_emitted"] == len(ref)
        target._thread.join(30)
        assert target.crashed and target.engine.pool.blocks_in_use == 0
        h.worker.drain()
        assert h.worker.engine.pool.blocks_in_use == 0
    finally:
        _shutdown(workers, sup)


def test_watchdog_condemns_a_stalled_replica(weights):
    ref = Engine(weights[1], _cfg(), device="cpu", register_profiler=False
                 ).generate(FAIL_PROMPT, SamplingParams(max_new_tokens=24))
    workers, router = _fleet(weights[1])
    sup = FleetSupervisor(router, watchdog_timeout_s=None, interval_s=0.02)
    try:
        target, _ = router.route(FAIL_PROMPT)
        target.set_faults(FaultInjector(FaultPlan([
            FaultSpec(SITE_WORKER_DISPATCH, FAULT_STALL, at=2)])))
        target.watchdog_timeout_s = 0.3
        sup.start()
        h, w0, _ = router.submit(FAIL_PROMPT,
                                 sampling=SamplingParams(max_new_tokens=24))
        assert w0 is target
        got, fin = _drain_handle(h)
        assert (got, fin) == (ref, "length")
        assert sup.condemned == [(target.name, "watchdog_stall")]
        assert sup.failovers == 1
        target._thread.join(30)
        assert target.crashed and target.engine.pool.blocks_in_use == 0
        h.worker.drain()
        assert h.worker.engine.pool.blocks_in_use == 0
    finally:
        _shutdown(workers, sup)


def test_crash_failover_through_the_gateway(weights):
    """The same crash under a live gateway: the SSE client sees one
    uninterrupted stream, and shutdown drains the survivor clean."""
    sp = dict(max_tokens=24, **SEEDED)
    ref = Engine(weights[1], _cfg(), device="cpu", register_profiler=False
                 ).generate(FAIL_PROMPT, SamplingParams(
                     max_new_tokens=24, **SEEDED))
    engines = [Engine(weights[1], _cfg(), device="cpu") for _ in range(2)]
    gw = Gateway(engines, GatewayConfig(watchdog_interval_s=0.02)).start()
    try:
        target, _ = gw.router.route(FAIL_PROMPT)
        target.set_faults(FaultInjector(FaultPlan([
            FaultSpec(SITE_WORKER_DISPATCH, FAULT_CRASH, at=2)])))
        r = _post(gw.port, dict(sp, prompt=FAIL_PROMPT, stream=True))
        assert _parse_sse(r.body.decode()) == (ref, "length")
        assert gw.supervisor.stats()["failovers"] == 1
        status, body = _get(gw.port, "/readyz")
        replicas = json.loads(body)["replicas"]
        assert status == 200 and not replicas[target.name]["healthy"]
    finally:
        gw.shutdown()
    assert [e.pool.blocks_in_use for e in engines] == [0, 0]
