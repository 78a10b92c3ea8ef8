"""The port's observability modules (``paddle_tpu_torch.observability``)
against the JAX package's on the CPU: the same operations give the same
Prometheus text byte for byte, the same SLO decisions, the same flight
records and the same telemetry-server answers.  Every compared quantity
is a host decision or a count, so the tolerance is exact.  Also: no new
port module imports ``jax`` or ``paddle_tpu``."""

import http.client
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.observability import events as jevents
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.observability.server import TelemetryServer as JServer
from paddle_tpu_torch.observability import events, metrics, slo, tracing
from paddle_tpu_torch.observability.server import (
    PROM_CONTENT_TYPE, TelemetryServer,
)
from paddle_tpu_torch.observability.span import SPAN_SECONDS, span

ROOT = Path(__file__).resolve().parents[1]

# every module this slice adds to the port
NEW_MODULES = (
    "paddle_tpu_torch.observability",
    "paddle_tpu_torch.observability.metrics",
    "paddle_tpu_torch.observability.events",
    "paddle_tpu_torch.observability.span",
    "paddle_tpu_torch.observability.tracing",
    "paddle_tpu_torch.observability.slo",
    "paddle_tpu_torch.observability.server",
    "paddle_tpu_torch.serving.faults",
    "paddle_tpu_torch.serving.gateway",
    "paddle_tpu_torch.serving.gateway.admission",
    "paddle_tpu_torch.serving.gateway.router",
    "paddle_tpu_torch.serving.gateway.protocol",
    "paddle_tpu_torch.serving.engine",
    "paddle_tpu_torch.serving",
)


# ------------------------------------------------------------------ metrics
def _metric_ops(mod, seed):
    """One sequence of counter, gauge, histogram and provider operations
    on a private registry of ``mod`` (the JAX or the port's metrics)."""
    r = np.random.RandomState(seed)
    reg = mod.Registry()
    c = reg.counter("serving.tokens_generated",
                    "tokens sampled across prefill+decode")
    g = reg.gauge("serving.queue_depth",
                  'a "quoted" help with a \\ backslash\nand a newline')
    h = reg.histogram("serving.ttft_seconds", "TTFT",
                      buckets=(0.001, 0.01, 0.1, 1.0), reservoir=16)
    for i in range(40):
        eng = f"serving.engine{r.randint(1, 4)}"
        c.inc(int(r.randint(0, 9)), engine=eng)
        g.set(float(r.randint(0, 50)) / 4, engine=eng)
        g.dec(0.5, engine=eng, lane=i % 3)
        h.observe(float(r.exponential(0.05)), engine=eng,
                  tenant='t"' + str(i % 2))
    g.set(float("nan"), engine="nan")
    g.set(float("inf"), engine="inf")
    g.set(float("-inf"), engine="ninf")
    reg.register_provider("serving.engine9",
                          lambda: {"queue_depth": 3, "rate": 0.25,
                                   "label": "not a number"})
    reg.register_provider("broken", lambda: 1 / 0)
    return reg, h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_prometheus_is_the_jax_text_byte_for_byte(seed):
    (jreg, jh), (treg, th) = _metric_ops(jmetrics, seed), \
        _metric_ops(metrics, seed)
    text = treg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert metrics.validate_exposition(text) == \
        jmetrics.validate_exposition(text) > 0
    # the snapshot and the exact percentiles from the reservoir, too
    assert json.dumps(treg.snapshot(), sort_keys=True, default=repr) == \
        json.dumps(jreg.snapshot(), sort_keys=True, default=repr)
    for q in (50, 95, 99):
        assert th.percentile(q, engine="serving.engine1", tenant='t"0') \
            == jh.percentile(q, engine="serving.engine1", tenant='t"0')


BAD_EXPOSITIONS = [
    "bad-name 1\n",
    "# TYPE x gauge\n# TYPE x gauge\nx 1\n",
    'x{a="1",a="2"} 1\n',
    'x{a="unterminated} 1\n',
    "x 1\nx 2\n",
    "x notanumber\n",
    "# TYPE h histogram\nh_bucket 1\n",
    "x 1\n# TYPE x counter\n",
    " x 1\n",
    "# TYPE x nonsense\nx 1\n",
]


@pytest.mark.parametrize("doc", BAD_EXPOSITIONS)
def test_validate_exposition_rejects_as_the_jax_checker(doc):
    with pytest.raises(ValueError) as tp:
        metrics.validate_exposition(doc)
    with pytest.raises(ValueError) as jx:
        jmetrics.validate_exposition(doc)
    assert str(tp.value) == str(jx.value)


def test_registry_kind_clash_and_counter_guard():
    reg = metrics.Registry()
    reg.counter("a.b")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("a.b")
    with pytest.raises(ValueError, match="only increase"):
        reg.counter("a.b").inc(-1)
    reg.register_provider("p", lambda: {"x": 1})
    reg.unregister_provider("p")
    assert reg.provider_counters() == {}


def test_metrics_are_thread_safe():
    """8 threads increment one counter and observe one histogram with a
    short switch interval: no update is lost."""
    import threading

    reg = metrics.Registry()
    c, h = reg.counter("c"), reg.histogram("h", reservoir=10)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            (c.inc(engine="e"), h.observe(0.5, engine="e"))
            for _ in range(2000)]) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert c.value(engine="e") == 16000
    assert h.stats(engine="e")["count"] == 16000


# ---------------------------------------------------------------------- SLO
def _slo_run(mod, seq):
    """Feed ``seq`` of (objective, value) through a tracker with TTFT,
    TPOT and abort objectives; returns the history of (healthy, idle,
    burn rates) after every observation and the final snapshot."""
    trk = mod.SLOTracker("t", registry=(jmetrics if mod is jslo
                                        else metrics).Registry())
    trk.declare("ttft", 0.5, target=0.9, fast_window=4, slow_window=12)
    trk.declare("tpot", 0.05, target=0.95, fast_window=3, slow_window=9)
    trk.declare("abort", 0.5, target=0.9, unit="bool", fast_window=5,
                slow_window=10)
    hist = [(trk.healthy, trk.idle)]
    for name, v in seq:
        trk.observe(name, v)
        hist.append((trk.healthy, trk.idle) + tuple(
            round(o.burn_rate(w), 12) for o in trk.objectives().values()
            for w in ("fast", "slow")))
    return hist, trk.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slo_tracker_decides_as_the_jax_tracker(seed):
    r = np.random.RandomState(seed)
    seq = []
    for i in range(120):
        name = ("ttft", "tpot", "abort", "unknown")[r.randint(0, 4)]
        burst = (i // 30) % 2          # bursts of breaches, then calm
        v = {"ttft": r.exponential(0.8 if burst else 0.1),
             "tpot": r.exponential(0.08 if burst else 0.01),
             "abort": float(r.rand() < (0.5 if burst else 0.02)),
             "unknown": 9.0}[name]
        seq.append((name, float(v)))
    (jh, js), (th, ts) = _slo_run(jslo, seq), _slo_run(slo, seq)
    assert th == jh
    assert ts == js
    assert any(not h[0] for h in th) and th[-1][1] is False


def test_slo_objective_validation():
    with pytest.raises(ValueError):
        slo.Objective("x", 1.0, target=1.0)
    with pytest.raises(ValueError):
        slo.Objective("x", 1.0, fast_window=8, slow_window=4)


# ------------------------------------------------------------------ tracing
def _trace_ops(mod):
    rec = mod.FlightRecorder(capacity=3)
    traces = []
    for rid in range(6):
        tr = rec.attach(mod.RequestTrace(rid, engine="e"))
        tr.add(mod.QUEUED, prompt_len=4)
        tr.add(mod.PREFILL, prefix_hit_tokens=rid)
        tr.add(mod.FIRST_TOKEN, token=1)
        tr.add(mod.DECODE, tokens=3, accepted=1)
        if rid % 3 == 1:
            tr.add(mod.PREEMPT)
            tr.add(mod.RESUME, prefix_hit_tokens=16)
        if rid % 3 == 2:
            tr.add(mod.FAILOVER, resumed_tokens=2)
            tr.add(mod.DECODE, tokens=5)
        tr.add(mod.ABORT if rid == 4 else mod.FINISH)
        if rid < 5:
            rec.finish(tr)
        traces.append(tr)
    return rec, traces


def test_flight_records_count_as_the_jax_records():
    (jrec, jtr), (trec, ttr) = _trace_ops(jtracing), _trace_ops(tracing)
    assert [t.counts() for t in ttr] == [t.counts() for t in jtr]
    assert [t.request_id for t in trec.recent()] == \
        [t.request_id for t in jrec.recent()] == [2, 3, 4]
    assert [t.request_id for t in trec.live()] == [5]
    assert trec.dropped == jrec.dropped == 2
    assert trec.get(5) is ttr[5] and trec.get(0) is None
    doc, jdoc = trec.to_json(), jrec.to_json()
    for d in (doc, jdoc):
        for t in d["live"] + d["recent"]:
            t.pop("submit_wall_time"), t.pop("duration_s")
            for e in t["events"]:
                e.pop("t")
    assert doc == jdoc
    chrome = json.loads(trec.export_chrome_trace())["traceEvents"]
    # one closed async span per retained or live trace that ended
    assert [e["ph"] for e in chrome].count("e") == 4


# ------------------------------------------------------- events and spans
def test_event_log_ring_and_chrome_export():
    logs = [jevents.EventLog(capacity=4), events.EventLog(capacity=4)]
    for log in logs:
        for i in range(6):
            log.instant("serving.tick", cat="serving", i=i)
        log.begin("phase", n=1)
        log.end("phase")
    (jlog, tlog) = logs
    assert tlog.dropped == jlog.dropped == 4
    assert [(e.name, e.phase, e.args) for e in tlog.events()] == \
        [(e.name, e.phase, e.args) for e in jlog.events()]
    doc = json.loads(tlog.export_chrome_trace())
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts) and len(ts) == 4
    assert doc["metadata"]["dropped_events"] == 4
    assert doc["metadata"]["mesh"] is None   # no process group is live


def test_span_is_a_profiler_range_an_event_pair_and_a_histogram():
    before = SPAN_SECONDS.stats(name="port.test_span", phase="x")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("port.test_span", phase="x"):
            torch.ones(4) + 1
    assert "port.test_span" in {e.name for e in prof.events()}
    after = SPAN_SECONDS.stats(name="port.test_span", phase="x")
    assert after["count"] == (before["count"] if before else 0) + 1
    pair = [e.phase for e in events.events(name="port.test_span")][-2:]
    assert pair == [events.BEGIN, events.END]
    with pytest.raises(KeyError):
        with span("port.test_span", phase="x"):
            raise KeyError("boom")
    assert SPAN_SECONDS.stats(name="port.test_span", phase="x",
                              error=1)["count"] >= 1


# ----------------------------------------------------------------- server
def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def test_telemetry_server_routes_answer_as_the_jax_server():
    trackers, recs = [], []
    for smod, mmod, tmod in ((jslo, jmetrics, jtracing),
                             (slo, metrics, tracing)):
        trk = smod.SLOTracker("srv", registry=mmod.Registry())
        trk.declare("ttft", 0.1, fast_window=2, slow_window=2)
        rec = tmod.FlightRecorder(4)
        rec.attach(tmod.RequestTrace(7, engine="e")).add(tmod.QUEUED)
        trackers.append(trk)
        recs.append(rec)
    jsrv = JServer(recorder=recs[0], slo=trackers[0])
    with TelemetryServer(port=0, recorder=recs[1],
                         slo=trackers[1]) as srv:
        assert srv.running and srv.port
        status, ctype, body = _get(srv.port, "/metrics")
        assert status == 200 and ctype == PROM_CONTENT_TYPE
        metrics.validate_exposition(body.decode())
        assert _get(srv.port, "/healthz")[::2] == (200, b"ok\n")
        for burn in (False, True):
            if burn:
                for trk in trackers:
                    for _ in range(3):
                        trk.observe("ttft", 1.0)
            for path in ("/readyz", "/debug/slo", "/debug/requests"):
                status, _, body = _get(srv.port, path)
                jstatus, _, jbody = jsrv.handle(path)
                assert status == jstatus == (503 if burn and
                                             path == "/readyz" else 200)
                got, want = json.loads(body), json.loads(jbody)
                if path == "/debug/requests":
                    for d in (got, want):
                        for t in d["live"]:
                            t.pop("submit_wall_time")
                            t.pop("duration_s")
                            for e in t["events"]:
                                e.pop("t")
                assert got == want, path
        status, _, body = _get(srv.port, "/trace")
        assert status == 200 and "traceEvents" in json.loads(body)
        for gone in ("/debug/programs", "/debug/comms", "/nope"):
            assert _get(srv.port, gone)[0] == 404
    assert not srv.running


# ---------------------------------------------------------------- imports
def test_new_port_modules_import_without_jax():
    """Every module of this slice imports in a fresh interpreter in which
    ``import jax`` and ``import paddle_tpu`` fail."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'paddle_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {list(NEW_MODULES)!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         cwd=ROOT, timeout=120, capture_output=True,
                         text=True)
    assert out.stdout.strip() == "ok"
