"""The port engine's request lifecycle against the JAX engine on the same
TINY weights (``port_model(cfg, jax_model(cfg))``): deadline aborts, the
tenant ledger, ``drain()``, ``counters()`` on the shared key set, the
failover entry point ``submit(resume_ids=)``, flight records, and the
degradation ladder climbing on ``slo_burn``.  Exact: every compared
quantity is a host decision, a count or a token id."""

import time

import numpy as np
import pytest

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, TINY_GQA, jax_model, one_thread, port_model,
)

# the JAX engine's counters() keys the port leaves out: XLA dispatch and
# compile-cache counts
OMITTED = {"decode_calls", "decode_compiles", "decode_cache_hits",
           "prefill_compiles", "prefill_cache_hits"}
# the port's counters() keys the JAX engine keeps only as a histogram
# family (serving.grammar_masked_fraction)
PORT_ONLY = {"grammar_masked_fraction"}
# wall-clock quantities: present in both, equal in neither
TIMED = {"ttft_avg_s", "tokens_per_s"}


def _pair(cfg, seed, **kw):
    jm = jax_model(cfg, seed=seed)
    return (JEngine(jm, JEngineConfig(**kw), register_profiler=False),
            Engine(port_model(cfg, jm), EngineConfig(**kw), device="cpu",
                   register_profiler=False))


def _sp(eng, **kw):
    return (JSamplingParams if isinstance(eng, JEngine)
            else SamplingParams)(**kw)


def _outs(reqs):
    return [[int(t) for t in r.output_ids] for r in reqs]


def _assert_counters_equal(jeng, eng):
    jc, c = jeng.counters(), eng.counters()
    assert set(jc) - set(c) == OMITTED
    assert set(c) - set(jc) == PORT_ONLY
    for k in sorted(set(c) - TIMED - PORT_ONLY):
        assert c[k] == jc[k], (k, c[k], jc[k])
    assert (set(c) & TIMED) == (set(jc) & TIMED)


def _prompts(cfg, lengths, seed):
    r = np.random.RandomState(seed)
    return [r.randint(1, cfg.vocab_size, n).tolist() for n in lengths]


def test_deadline_tenants_and_counters_as_the_jax_engine(cfg=TINY):
    """One slot: the first request runs, a queued one with a passed
    deadline aborts at the next admission pass, the others finish.  Both
    engines: the same streams and finish reasons, the same tenant ledger
    and the same counters on the shared keys."""
    kw = dict(num_slots=1, max_seq_len=64, max_horizon=2)
    prompts = _prompts(cfg, (6, 9, 4, 7), 1)
    runs = {}
    for eng in _pair(cfg, 1, **kw):
        reqs = [eng.submit(prompts[0], _sp(eng, max_new_tokens=6),
                           tenant="acme"),
                eng.submit(prompts[1], _sp(eng, max_new_tokens=6),
                           deadline_s=0.01, tenant="acme"),
                eng.submit(prompts[2], _sp(eng, max_new_tokens=5),
                           deadline_s=60.0, tenant="beta"),
                eng.submit(prompts[3], _sp(eng, max_new_tokens=4))]
        time.sleep(0.03)                     # the short deadline passes
        eng.run()
        doomed = reqs[1]
        assert doomed.finish_reason == "abort" and not doomed.output_ids
        kinds = [k for k, _, _ in doomed.trace.events]
        assert kinds == ["queued", "abort"]
        assert doomed.trace.events[-1][2]["cause"] == "deadline"
        assert eng.counters()["deadline_expired"] == 1
        runs[type(eng)] = (_outs(reqs), [r.finish_reason for r in reqs],
                           eng.tenant_ledger(), eng.stats()["tenants"])
    assert runs[Engine] == runs[JEngine]
    assert runs[Engine][2] == {
        "acme": {"submitted": 2, "finished": 1, "aborted": 1,
                 "tokens_generated": 6},
        "beta": {"submitted": 1, "finished": 1, "aborted": 0,
                 "tokens_generated": 5},
        "": {"submitted": 1, "finished": 1, "aborted": 0,
             "tokens_generated": 4}}


def test_counters_match_on_a_mixed_workload(cfg=TINY_GQA):
    """Chunked prefill, prefix hits, spec decoding and a preempting pool:
    ``counters()`` equal the JAX engine's on every shared key, the
    flight records' token sums equal ``tokens_generated``."""
    kw = dict(num_slots=3, max_seq_len=64, max_horizon=4,
              prefix_block_size=4, min_prefill_bucket=4,
              prefill_chunk_tokens=8, spec_k=2, kv_pool_blocks=24)
    shared = _prompts(cfg, (12,), 2)[0]
    prompts = [shared + p for p in _prompts(cfg, (3, 5, 2, 9), 3)] + \
        _prompts(cfg, (14,), 4)
    engines = _pair(cfg, 2, **kw)
    outs = []
    for eng in engines:
        reqs = [eng.submit(p, _sp(eng, max_new_tokens=9 + i % 3))
                for i, p in enumerate(prompts)]
        eng.run()
        outs.append(_outs(reqs))
        traced = sum(r.trace.counts()["tokens_emitted"] for r in reqs)
        assert traced == eng.counters()["tokens_generated"]
    jeng, eng = engines
    assert outs[0] == outs[1]
    _assert_counters_equal(jeng, eng)
    c = eng.counters()
    assert c["prefix_hit_tokens"] > 0 and c["prefill_chunk_dispatches"] > 0
    assert c["spec_draft_tokens"] > 0


def test_drain_as_the_jax_engine(cfg=TINY):
    """drain() after one step: the queued backlog aborts (cause
    ``drain``), the running lanes finish, every pool block is released
    (the prefix store's too), draining refuses submissions meanwhile, and
    the engine serves again afterwards."""
    kw = dict(num_slots=2, max_seq_len=64, max_horizon=2,
              prefix_block_size=4, min_prefill_bucket=4)
    prompts = _prompts(cfg, (9, 6, 8, 5), 5)
    runs = {}
    for eng in _pair(cfg, 5, **kw):
        reqs = [eng.submit(p, _sp(eng, max_new_tokens=5 + i))
                for i, p in enumerate(prompts)]
        eng.step()
        assert eng.pool.blocks_in_use > 0
        retired = eng.drain()
        assert eng.pool.blocks_in_use == 0
        assert eng.stats()["kv_pool"]["blocks_in_use"] == 0
        assert not eng.stats()["draining"]
        causes = [r.trace.events[-1][2].get("cause") for r in reqs]
        again = eng.submit(prompts[0], _sp(eng, max_new_tokens=3))
        eng.run()
        runs[type(eng)] = (_outs(reqs), [r.finish_reason for r in reqs],
                           [r.request_id for r in retired], causes,
                           _outs([again]))
    assert runs[Engine] == runs[JEngine]
    assert runs[Engine][1] == ["length", "length", "abort", "abort"]
    assert runs[Engine][3][2:] == ["drain", "drain"]


def test_submit_while_draining_is_refused():
    eng = Engine(port_model(TINY, jax_model(TINY)),
                 EngineConfig(num_slots=1, max_seq_len=32), device="cpu",
                 register_profiler=False)
    eng.submit([1, 2, 3], SamplingParams(max_new_tokens=3))
    eng.step()                               # running: drain steps it
    seen = []
    step = eng.step

    def probe(*a, **k):
        with pytest.raises(RuntimeError, match="draining"):
            eng.submit([4, 5], SamplingParams(max_new_tokens=2))
        seen.append(True)
        return step(*a, **k)

    eng.step = probe
    eng.drain()
    assert seen
    # a grammar on an engine without structured generation is refused
    # as the JAX engine refuses it; with the knobs on it queues
    with pytest.raises(ValueError, match="grammar_max_states"):
        eng.submit([1, 2], SamplingParams(eos_token_id=0),
                   grammar="[0-9]+")
    vocab = [chr(32 + i) for i in range(95)] + ["<eos>"]
    structured = Engine(port_model(TINY, jax_model(TINY)), EngineConfig(
        num_slots=1, max_seq_len=32, grammar_max_states=16,
        grammar_vocab=vocab), device="cpu", register_profiler=False)
    req = structured.submit([1, 2], SamplingParams(eos_token_id=95),
                            grammar="[0-9]+")
    assert structured.scheduler.queue_depth == 1
    assert req.grammar.kind == "regex"
    assert structured.stats()["structured"]["grammars_installed"] == 1
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit([1, 2], deadline_s=0)
    with pytest.raises(ValueError, match="nothing left"):
        eng.submit([1, 2], SamplingParams(max_new_tokens=2),
                   resume_ids=[3, 4])


# ---------------------------------------------------------------- resume
@CONFIGS
@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_resume_ids_continue_a_stream_bitwise(cfg, seeded):
    """A second port engine over the same weights takes over a stream
    after k tokens (``submit(resume_ids=stream[:k])``): the continuation
    equals the uninterrupted stream bit for bit at every cut, the
    resumed tokens are not counted as generated, and the flight record
    shows a resume.  The greedy continuation equals the JAX engine's
    resume too (one cut, MHA)."""
    jm = jax_model(cfg, seed=6)
    kw = dict(num_slots=2, max_seq_len=64, max_horizon=4)
    sp = dict(max_new_tokens=14)
    if seeded:
        sp.update(temperature=0.8, top_k=24, top_p=0.9, seed=17)
    prompt = _prompts(cfg, (11,), 6)[0]
    first = Engine(port_model(cfg, jm), EngineConfig(**kw), device="cpu",
                   register_profiler=False)
    ref = [int(t) for t in first.generate(prompt, SamplingParams(**sp))]
    second = Engine(port_model(cfg, jm), EngineConfig(**kw), device="cpu",
                    register_profiler=False)
    # the JAX engine's greedy resume, on one config (its compiles dominate)
    jeng = (JEngine(jm, JEngineConfig(**kw), register_profiler=False)
            if not seeded and cfg is TINY else None)
    for k in (1, 5, 13):
        before = second.counters()["tokens_generated"]
        req = second.submit(prompt, SamplingParams(**sp),
                            resume_ids=ref[:k])
        assert req.resumed
        second.run()
        assert [int(t) for t in req.output_ids] == ref, k
        assert second.counters()["tokens_generated"] - before == 14 - k
        kinds = [e[0] for e in req.trace.events]
        assert kinds[:2] == ["queued", "resume"]
        assert req.trace.events[0][2]["resumed_tokens"] == k
        if jeng is not None and k == 5:
            jreq = jeng.submit(prompt, JSamplingParams(**sp),
                               resume_ids=ref[:k])
            jeng.run()
            assert [int(t) for t in jreq.output_ids] == ref
    second.drain()
    assert second.pool.blocks_in_use == 0


def test_resume_with_a_wrong_boundary_token_raises():
    """The boundary token is re-sampled and checked: a history whose
    last token the weights would not sample is refused at admission."""
    jm = jax_model(TINY, seed=7)
    eng = Engine(port_model(TINY, jm), EngineConfig(num_slots=1,
                                                    max_seq_len=32),
                 device="cpu", register_profiler=False)
    prompt = [3, 9, 27, 81, 2]
    ref = eng.generate(prompt, SamplingParams(max_new_tokens=6))
    bad = ref[:3]
    bad[-1] = (bad[-1] + 1) % TINY.vocab_size
    eng.submit(prompt, SamplingParams(max_new_tokens=6), resume_ids=bad)
    with pytest.raises(RuntimeError, match="resume diverged"):
        eng.run()


# ------------------------------------------------------ SLO and the ladder
def test_slo_burn_climbs_the_ladder_as_the_jax_engine(cfg=TINY_GQA):
    """A TTFT objective no request can meet (1 ns, windows of 2): once
    two requests retired both windows burn, and both engines' ladders
    climb on ``slo_burn`` at the same steps; the burning tracker drops
    the engine out of readiness."""
    kw = dict(num_slots=2, max_seq_len=64, max_horizon=2,
              slo_ttft_s=1e-9, slo_fast_window=2, slo_slow_window=2,
              degrade_patience=2, degrade_recover_patience=3)
    prompts = _prompts(cfg, (5, 7, 4, 6, 8, 5, 3, 9), 8)
    seen = {}
    for eng in _pair(cfg, 8, **kw):
        reqs = [eng.submit(p, _sp(eng, max_new_tokens=3 + i % 3))
                for i, p in enumerate(prompts)]
        levels, healthy = [], []
        while eng.scheduler.has_work:
            eng.step()
            levels.append(eng._degrade_level)
            healthy.append(eng.slo.healthy)
        seen[type(eng)] = (levels, healthy, eng._degrade_history,
                           [r.finish_reason for r in reqs], _outs(reqs),
                           eng.stats()["degradation"],
                           eng.slo.snapshot()["objectives"]["ttft"][
                               "breaches"])
    assert seen[Engine] == seen[JEngine]
    levels, healthy, history = seen[Engine][:3]
    assert max(levels) >= 1 and not healthy[-1]
    assert history[0]["reason"] == "slo_burn"


def test_slo_ladder_hysteresis_on_scripted_observations():
    """The JAX engine's scripted walk (patience 2, recovery 3) through
    both engines' trackers and ladders, tick for tick."""
    kw = dict(num_slots=2, max_seq_len=32, slo_ttft_s=0.01,
              slo_fast_window=4, slo_slow_window=4, degrade_patience=2,
              degrade_recover_patience=3)
    script = [True] * 8 + [False] * 3 + [True] + [False] * 4
    walks = {}
    for eng in _pair(TINY, 0, **kw):
        walk = []
        for burn in script:
            for _ in range(4):
                eng.slo.observe("ttft", 1.0 if burn else 0.0)
            eng._update_degradation()
            walk.append((eng._degrade_level, eng.slo.healthy,
                         eng._resolve_spec_k(), eng._resolve_horizon(1)))
        walks[type(eng)] = (walk, eng._degrade_history)
    assert walks[Engine] == walks[JEngine]
    assert [w[0] for w in walks[Engine][0]][:8] == [0, 1, 1, 2, 2, 3, 3, 3]


def test_engine_publishes_serving_families_and_provider():
    """The engine's ``serving.*`` families carry its name as the
    ``engine`` label, its counters() ride the process registry as a
    provider until close(), and the exposition stays valid."""
    eng = Engine(port_model(TINY, jax_model(TINY)),
                 EngineConfig(num_slots=2, max_seq_len=32,
                              telemetry_port=0), device="cpu")
    name = eng._profiler_name
    eng.generate([[1, 2, 3], [4, 5, 6, 7]],
                 SamplingParams(max_new_tokens=4))
    reg = metrics.default_registry()
    assert reg.value("serving.requests_finished", engine=name) == 2
    assert reg.value("serving.tokens_generated", engine=name) == 8
    assert reg.value("serving.ttft_seconds", engine=name)["count"] == 2
    assert reg.value("serving.kv_blocks_in_use", engine=name) == 0
    assert reg.provider_counters()[name]["tokens_generated"] == 8
    metrics.validate_exposition(reg.render_prometheus())
    assert eng.telemetry.running and eng.stats()["telemetry_port"]
    eng.close()
    assert not eng.telemetry.running
    assert name not in reg.provider_counters()
