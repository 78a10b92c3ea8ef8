"""The port's degradation ladder and ``Engine.abort`` on the CPU, against
the JAX engine on the same weights (``port_model(cfg, jax_model(cfg))``).

Both engines run with JAX's defaults (``degrade_enabled=True``, pool
ratio 0.92, patience 4, recovery 16), so under an undersized pool their
host decisions must stay equal: greedy streams, the spec and pool
counters, sheds, preemptions, decode steps and ``stats()["degradation"]``
(level, name, transitions, sheds and the last transitions with their
reasons and horizon counts).  The SLO signal is not ported yet; pool
pressure is the only signal either engine fires without ``slo_*``
targets.
"""

import numpy as np
import pytest

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving.engine import DEGRADE_LEVELS

from _torch_port_util import (  # noqa: F401
    TINY, jax_model, one_thread, port_model,
)


def _pair(seed, **kw):
    """The JAX engine and the port's on the same TINY weights."""
    jm = jax_model(TINY, seed=seed)
    return (JEngine(jm, JEngineConfig(**kw), register_profiler=False),
            Engine(port_model(TINY, jm), EngineConfig(**kw), device="cpu"))


def _run(eng, prompts, budgets):
    sp = JSamplingParams if isinstance(eng, JEngine) else SamplingParams
    reqs = [eng.submit(p, sp(max_new_tokens=n))
            for p, n in zip(prompts, budgets)]
    eng.run()
    return reqs


def _outs(reqs):
    return [[int(t) for t in r.output_ids] for r in reqs]


def _counters(eng):
    c = eng.stats()
    return {k: c[k] for k in ("preemptions", "decode_steps",
                              "degradation_level", "degradation_sheds",
                              "requests_aborted", "prefill_calls")}


def test_config_defaults_are_the_jax_engines():
    jc, tc = JEngineConfig(), EngineConfig()
    for name in ("degrade_enabled", "degrade_pool_ratio",
                 "degrade_patience", "degrade_recover_patience"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert DEGRADE_LEVELS == ("normal", "no_spec", "horizon_1", "shed")


def test_pool_pressure_turns_spec_off_as_the_jax_engine():
    """An undersized pool (4 blocks of 8 for one slot of 64) with spec
    K = 1: the pool stays at or above 92 % for 4 steps, both engines
    climb to level 1, and their last horizons run K = 0."""
    kw = dict(num_slots=1, max_seq_len=64, max_horizon=1,
              prefix_block_size=8, min_prefill_bucket=4, spec_k=1,
              spec_adaptive=False, kv_pool_blocks=4)
    prompts = [[62, 2, 59, 38, 118, 90, 124, 42, 88, 22, 37, 91],
               [7, 21, 127, 7], [111, 84, 1, 78, 45, 69, 90, 122, 49, 19, 12]]
    budgets = [4, 5, 6]
    jeng, eng = _pair(1, **kw)
    ref, out = _run(jeng, prompts, budgets), _run(eng, prompts, budgets)
    assert _outs(out) == _outs(ref)
    js, ts = jeng.stats(), eng.stats()
    assert ts["spec"]["draft_tokens"] == js["spec"]["draft_tokens"] == 11
    assert ts["kv_blocks_in_use"] == js["kv_blocks_in_use"] == 2
    assert ts["degradation"] == js["degradation"]
    assert ts["degradation"]["level_name"] == "no_spec"
    assert ts["degradation"]["history"][0]["reason"] == "pool_pressure"
    assert _counters(eng) == _counters(jeng)


def test_level3_sheds_as_the_jax_engine():
    """4 requests through one slot of a 6-block pool with chunked
    prefill, spec K = 4 and int8 weights and KV: both engines reach
    level 3 and shed the same queued request, whose stream stays
    empty."""
    kw = dict(num_slots=1, max_seq_len=48, max_horizon=4,
              prefix_block_size=4, min_prefill_bucket=4,
              prefill_chunk_tokens=8, spec_k=4, kv_pool_blocks=6,
              weight_dtype="int8", kv_cache_dtype="int8")
    prompts = [[102, 3, 102, 60, 65, 80, 37, 124, 7, 36],
               [72, 52, 17, 6, 1, 7, 19],
               [25, 83, 95, 30, 36, 55, 34, 123, 23, 114, 101, 107, 15],
               [80, 63, 84, 86, 84, 8, 121]]
    budgets = [8, 11, 5, 6]
    jeng, eng = _pair(0, **kw)
    ref, out = _run(jeng, prompts, budgets), _run(eng, prompts, budgets)
    assert _outs(out) == _outs(ref)
    assert [r.finish_reason for r in out] == [r.finish_reason for r in ref]
    shed = [r for r in out if r.finish_reason == "abort"]
    assert len(shed) == 1 and shed[0].output_ids == []
    assert _counters(eng) == _counters(jeng)
    assert eng.stats()["degradation"] == jeng.stats()["degradation"]
    assert eng.stats()["degradation"]["sheds"] == 1
    assert eng.pool.blocks_in_use == jeng.pool.blocks_in_use


# burning (True) or calm (False) ticks, and the level after each, at
# patience 2 and recovery 3: escalation to the top, topping out,
# hysteresis, and a burning tick resetting the calm streak
SIGNALS = [True] * 6 + [True] * 4 + [False] * 3 + [False] * 2 + [True] + \
    [False] * 2 + [False] + [False] * 3 + [False] * 3
LEVELS = [0, 1, 1, 2, 2, 3] + [3] * 4 + [3, 3, 2] + [2, 2] + [2] + \
    [2, 2] + [1] + [1, 1, 0] + [0] * 3


def test_scripted_signal_walks_the_jax_ladder(monkeypatch):
    """The same scripted signal through ``_update_degradation`` of both
    engines (``_degrade_signal`` patched alike): equal levels after
    every tick, equal histories, and the level's effect on the spec
    width and the horizon."""
    kw = dict(num_slots=2, max_seq_len=32, spec_k=4, spec_adaptive=False,
              degrade_patience=2, degrade_recover_patience=3)
    jeng, eng = _pair(0, **kw)
    levels = {}
    for e in (jeng, eng):
        it = iter(SIGNALS)
        monkeypatch.setattr(e, "_degrade_signal",
                            lambda it=it: "pool_pressure" if next(it)
                            else None)
        seen = []
        for _ in SIGNALS:
            e._update_degradation()
            seen.append(e._degrade_level)
            assert e._resolve_spec_k() == (0 if e._degrade_level else 4)
            if e._degrade_level >= 2:
                assert e._resolve_horizon() == 1
        levels[type(e)] = seen
    assert levels[Engine] == levels[JEngine] == LEVELS
    assert eng.stats()["degradation"] == jeng.stats()["degradation"]
    assert [h["reason"] for h in eng._degrade_history] == \
        ["pool_pressure"] * 3 + ["recovered"] * 3
    assert eng._degrade_history == jeng._degrade_history


def test_level3_never_sheds_a_resumed_request():
    """A preempted request waits at the queue front as ``resumed``; at
    level 3 the queue is shed down to ``num_slots`` by the newest fresh
    request, never the resumed one, which then resumes exactly."""
    kw = dict(num_slots=2, max_seq_len=32, prefix_cache_bytes=0)
    r = np.random.RandomState(4)
    prompts = [r.randint(1, 127, n).tolist() for n in (9, 6, 7, 5)]
    budgets = [6, 5, 4, 4]
    alone = Engine(port_model(TINY, jax_model(TINY, seed=2)),
                   EngineConfig(**kw), device="cpu").generate(
        prompts[0], SamplingParams(max_new_tokens=budgets[0]))
    outs = {}
    for eng in _pair(2, **kw):
        sp = JSamplingParams if isinstance(eng, JEngine) else SamplingParams
        reqs = [eng.submit(p, sp(max_new_tokens=n))
                for p, n in zip(prompts, budgets)]
        eng.step()
        eng.preempt(reqs[0])
        assert reqs[0].resumed and len(eng.scheduler.queue) == 3
        eng._set_degrade_level(3, "test")
        eng.admit()
        assert [q.finish_reason for q in reqs] == [None, None, None, "abort"]
        eng.run()
        assert reqs[0].finish_reason == "length"
        assert reqs[3].output_ids == []
        assert eng.stats()["degradation_sheds"] == 1
        assert eng.pool.blocks_in_use == 0
        outs[type(eng)] = _outs(reqs)
    assert outs[Engine] == outs[JEngine]
    assert outs[Engine][0] == alone


def test_abort_frees_every_block():
    """``abort`` of a queued and of a running request: both finish as
    "abort", the running one's blocks go back at once, the survivor's
    stream equals the JAX engine's, the drained pool holds no block, and
    aborting a finished request raises."""
    kw = dict(num_slots=2, max_seq_len=32, prefix_cache_bytes=0)
    r = np.random.RandomState(5)
    prompts = [r.randint(1, 127, n).tolist() for n in (9, 6, 7)]
    outs = {}
    for eng in _pair(3, **kw):
        sp = JSamplingParams if isinstance(eng, JEngine) else SamplingParams
        reqs = [eng.submit(p, sp(max_new_tokens=5)) for p in prompts]
        eng.step()
        queued, running = reqs[2], reqs[1]
        assert queued.status == "waiting" and running.status == "running"
        eng.abort(queued)
        in_use = eng.pool.blocks_in_use
        eng.abort(running)
        assert eng.pool.blocks_in_use < in_use
        assert queued not in eng.scheduler.queue
        assert [q.finish_reason for q in reqs[1:]] == ["abort", "abort"]
        eng.run()
        assert eng.pool.blocks_in_use == 0
        assert eng.stats()["requests_aborted"] == 2
        with pytest.raises(ValueError, match="already finished"):
            eng.abort(reqs[0])
        with pytest.raises(ValueError, match="already finished"):
            eng.abort(queued)
        outs[type(eng)] = _outs(reqs)
    assert outs[Engine] == outs[JEngine]
