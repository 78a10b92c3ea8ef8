"""The port's serving engine with the prefix cache, chunked prefill and
preemption, on the CPU, against the JAX engine on the same weights
(``port_model(cfg, jax_model(cfg))``) and on the JAX engine's own test
workloads (``tests/test_serving.py``: ``TestPrefixReuse``,
``TestPreemptionSwap``, ``TestChunkedPrefill``; their speculative and
int8 cases belong to later slices).

Greedy streams, per-request ``prefix_hit_tokens``, the counters
(``cow_copies``, ``preemptions``, ``prefill_calls``,
``prefill_chunk_dispatches``), ``kv_blocks_capacity`` and the block
counts after the drain must equal the JAX engine's exactly.  Sampled
streams differ from the JAX engine's by design (torch generators, not
threefry bits), so they are held inside the port: prefix cache on = off
= one request at a time, chunked = whole, preempted = unpreempted, all
bitwise.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving.paged_attention import check_kernel_geometry

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, jax_compile_cache, jax_model, one_thread, port_model,
)

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

SHARED = [7, 3, 9, 1, 4, 4, 2, 8]                  # 2 blocks of 4
PREFIX_KW = dict(num_slots=4, max_seq_len=48, min_prefill_bucket=4,
                 prefix_block_size=4)
PREEMPT_KW = dict(num_slots=2, max_seq_len=32, max_horizon=4,
                  prefix_block_size=4, prefix_cache_bytes=0)
CHUNK_KW = dict(num_slots=4, max_seq_len=64, kv_pool_blocks=96)

_rng = np.random.default_rng(11)
BASE = list(map(int, _rng.integers(1, 95, 26)))
PROMPTS1 = [BASE, list(map(int, _rng.integers(1, 95, 9))),
            list(map(int, _rng.integers(1, 95, 23)))]
# a shared prefix ending AT a chunk boundary (16) and ACROSS one (20)
PROMPTS2 = [BASE[:16] + list(map(int, _rng.integers(1, 95, 7))),
            BASE[:20] + list(map(int, _rng.integers(1, 95, 5)))]


def _greedy(sp_cls, budgets):
    return [sp_cls(max_new_tokens=n) for n in budgets]


def _sampled(sp_cls, budgets, seed=3):
    return [sp_cls(max_new_tokens=n, temperature=0.8, top_k=20, top_p=0.9,
                   seed=seed + i) for i, n in enumerate(budgets)]


def _jax(jm, **kw):
    return JEngine(jm, JEngineConfig(program_cards=False, **kw),
                   register_profiler=False)


def _port(tm, **kw):
    return Engine(tm, EngineConfig(**kw), device="cpu")


def _outs(reqs):
    return [[int(t) for t in r.output_ids] for r in reqs]


def _counters(eng):
    """The counters the JAX engine keeps under the same names."""
    c = eng.counters() if isinstance(eng, JEngine) else eng.stats()
    return {k: c[k] for k in (
        "prefill_calls", "prefill_requests", "prefill_chunk_dispatches",
        "prefill_chunked_requests", "prefix_hit_tokens", "prompt_tokens",
        "cow_copies", "preemptions", "kv_blocks_in_use")}


def _warm_then_batch(eng, sp, prompts):
    """The JAX prefix workload: the first prompt alone (caching SHARED),
    then the rest together, hit, miss and COW lanes co-batched."""
    warm = eng.submit(prompts[0], sp[0])
    eng.run()
    reqs = [warm] + [eng.submit(p, s) for p, s in zip(prompts[1:], sp[1:])]
    eng.run()
    return reqs


PREFIX_PROMPTS = [SHARED + [5, 6, 7, 1], SHARED + [1, 2], [2, 2, 1],
                  SHARED + [9, 9, 9, 9, 2], SHARED + [5, 6, 9, 9, 3]]


@CONFIGS
def test_prefix_reuse_matches_the_jax_engine(cfg):
    jm = jax_model(cfg, seed=5)
    budgets = [5, 6, 4, 5, 5]
    jeng = _jax(jm, **PREFIX_KW)
    ref = _warm_then_batch(jeng, _greedy(JSamplingParams, budgets),
                           PREFIX_PROMPTS)
    eng = _port(port_model(cfg, jm), **PREFIX_KW)
    out = _warm_then_batch(eng, _greedy(SamplingParams, budgets),
                           PREFIX_PROMPTS)
    assert _outs(out) == _outs(ref)
    hits = [r.prefix_hit_tokens for r in out]
    assert hits == [r.prefix_hit_tokens for r in ref]
    assert hits == [0, 8, 0, 8, 10]          # the last: 8 + a COW tail of 2
    assert _counters(eng) == _counters(jeng)
    assert eng.stats()["cow_copies"] == 1
    assert eng.stats()["kv_blocks_capacity"] == jeng.pool.capacity
    assert eng.stats()["prefix"] == jeng.stats()["prefix"]
    # block-leak invariant: nothing leased, only the store's blocks live
    assert eng.cache.leased_blocks == 0 and eng._leases == {}
    assert eng.pool.blocks_in_use == eng.prefix.stats()["used_blocks"] > 0


def test_sampled_prefix_on_equals_off_equals_one_at_a_time():
    tm = port_model(TINY, jax_model(TINY, seed=5))
    budgets = [5, 6, 4, 5, 5]
    sp = _sampled(SamplingParams, budgets)
    sp[2] = SamplingParams(max_new_tokens=4)
    alone = [_port(tm, **dict(PREFIX_KW, num_slots=1, prefix_block_size=0))
             .generate(p, s) for p, s in zip(PREFIX_PROMPTS, sp)]
    on = _port(tm, **PREFIX_KW)
    assert _outs(_warm_then_batch(on, sp, PREFIX_PROMPTS)) == alone
    assert on.stats()["prefix_hit_tokens"] == 26
    off = _port(tm, **dict(PREFIX_KW, prefix_block_size=0))
    assert _outs(_warm_then_batch(off, sp, PREFIX_PROMPTS)) == alone
    assert off.stats()["prefix_hit_tokens"] == 0
    assert off.stats()["prefix"]["capacity_blocks"] == 0


def test_exact_resubmit_hits_all_but_the_last_token():
    jm = jax_model(TINY, seed=5)
    a = SHARED + [5, 6, 7, 1]                    # 12 tokens: 3 blocks
    outs = []
    for eng, sp in ((_jax(jm, **PREFIX_KW), JSamplingParams),
                    (_port(port_model(TINY, jm), **PREFIX_KW),
                     SamplingParams)):
        first = eng.generate(a, sp(max_new_tokens=5))
        again = eng.submit(a, sp(max_new_tokens=5))
        eng.run()
        assert [int(t) for t in again.output_ids] == [int(t) for t in first]
        # 2 leased blocks + a 3-token COW tail of cached block 3
        assert again.prefix_hit_tokens == 11
        outs.append(([int(t) for t in first], _counters(eng)))
    assert outs[1] == outs[0]


def _explicit_preempt(eng, sp, prompts):
    reqs = [eng.submit(p, s) for p, s in zip(prompts, sp)]
    eng.step(horizon=2)                          # both lanes decoding
    victim = reqs[1]
    held = int(np.count_nonzero(eng.cache.tables[victim.slot]))
    before = eng.pool.blocks_in_use
    eng.preempt(victim)
    assert victim.status == "waiting" and victim.slot is None
    assert eng.scheduler.queue[0] is victim
    assert held > 0 and eng.pool.blocks_in_use == before - held
    eng.run()
    return reqs


@CONFIGS
def test_explicit_preempt_resumes_like_the_jax_engine(cfg):
    jm = jax_model(cfg, seed=9)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    jeng = _jax(jm, **PREEMPT_KW)
    ref = _explicit_preempt(jeng, _greedy(JSamplingParams, [10, 10]),
                            prompts)
    tm = port_model(cfg, jm)
    eng = _port(tm, **PREEMPT_KW)
    out = _explicit_preempt(eng, _greedy(SamplingParams, [10, 10]), prompts)
    assert _outs(out) == _outs(ref)
    assert _counters(eng) == _counters(jeng)
    assert eng.stats()["preemptions"] == 1
    assert eng.pool.blocks_in_use == 0
    # sampled: the preempted stream equals the unpreempted one
    sp = _sampled(SamplingParams, [10, 10])
    alone = [_port(tm, **dict(PREEMPT_KW, num_slots=1)).generate(p, s)
             for p, s in zip(prompts, sp)]
    assert _outs(_explicit_preempt(_port(tm, **PREEMPT_KW), sp,
                                   prompts)) == alone


@CONFIGS
def test_undersized_pool_preempts_like_the_jax_engine(cfg):
    """7 allocatable blocks of 4: both requests admit (2 + 2) but cannot
    both grow to 20 tokens (5 + 5); decode preempts the younger one."""
    jm = jax_model(cfg, seed=9)
    prompts = [[7, 3, 9, 1, 4, 4, 2, 8], [5, 6, 7, 8, 9, 1, 2, 3]]
    kw = dict(PREEMPT_KW, kv_pool_blocks=8)
    jeng = _jax(jm, **kw)
    ref = [jeng.submit(p, s) for p, s in
           zip(prompts, _greedy(JSamplingParams, [12, 12]))]
    jeng.run()
    tm = port_model(cfg, jm)
    eng = _port(tm, **kw)
    out = [eng.submit(p, s) for p, s in
           zip(prompts, _greedy(SamplingParams, [12, 12]))]
    eng.run()
    assert _outs(out) == _outs(ref)
    assert _counters(eng) == _counters(jeng)
    assert eng.stats()["preemptions"] >= 1
    assert eng.stats()["kv_blocks_capacity"] == jeng.pool.capacity == 7
    assert eng.pool.blocks_in_use == 0
    sp = _sampled(SamplingParams, [12, 12], seed=20)
    alone = [_port(tm, **dict(PREEMPT_KW, num_slots=1)).generate(p, s)
             for p, s in zip(prompts, sp)]
    tight = _port(tm, **kw)
    assert tight.generate(prompts, sp) == alone
    assert tight.stats()["preemptions"] >= 1


def test_block_leak_invariant_with_and_without_the_store():
    tm = port_model(TINY, jax_model(TINY))
    prompts = [[1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 6, 7], [9, 9]]
    for budget in (0, 1 << 20):
        eng = _port(tm, **dict(PREEMPT_KW, prefix_cache_bytes=budget))
        eng.generate(prompts, SamplingParams(max_new_tokens=4))
        assert eng.cache.leased_blocks == 0
        assert eng.pool.blocks_in_use == eng.prefix.stats()["used_blocks"]
        assert (eng.pool.blocks_in_use == 0) == (budget == 0)


def _chunk_phases(eng, sp_cls, sampled):
    sp1 = [sp_cls(max_new_tokens=8), sp_cls(max_new_tokens=7),
           sp_cls(max_new_tokens=8)]
    sp2 = [sp_cls(max_new_tokens=6), sp_cls(max_new_tokens=6)]
    if sampled:
        sp1[1] = sp_cls(max_new_tokens=7, temperature=0.9, seed=5)
        sp1[2] = sp_cls(max_new_tokens=8, temperature=1.2, top_k=13, seed=2)
        sp2[1] = sp_cls(max_new_tokens=6, temperature=0.8, seed=9)
    return [[[int(t) for t in o] for o in eng.generate(PROMPTS1, sp1)],
            [[int(t) for t in o] for o in eng.generate(PROMPTS2, sp2)]]


@CONFIGS
def test_chunked_prefill_matches_the_jax_engine(cfg):
    """chunk=8 over two phases, the second hitting the radix store at
    and across chunk boundaries: the greedy streams and the chunk
    schedule equal the JAX engine's; no prefill bucket exceeds the
    chunk, yet the 26-token prompt completes."""
    jm = jax_model(cfg, seed=11)
    jeng = _jax(jm, prefill_chunk_tokens=8, **CHUNK_KW)
    ref = _chunk_phases(jeng, JSamplingParams, False)
    tm = port_model(cfg, jm)
    eng = _port(tm, prefill_chunk_tokens=8, **CHUNK_KW)
    assert _chunk_phases(eng, SamplingParams, False) == ref
    assert _counters(eng) == _counters(jeng)
    st, jst = eng.stats()["prefill"], jeng.stats()["prefill"]
    assert eng.stats()["prefill_chunked_requests"] >= 3
    assert st["chunks_in_flight"] == 0
    assert st["chunk_count_total"] == jst["chunk_count_total"]
    assert st["buckets"] == [tuple(b) for b in jst["buckets"]]
    assert all(b <= st["chunk_tokens"] == 8 for _, b in st["buckets"])
    assert eng.stats()["prefix_hit_tokens"] > 0
    whole = _port(tm, **CHUNK_KW)
    assert _chunk_phases(whole, SamplingParams, False) == ref
    assert max(b for _, b in whole.stats()["prefill"]["buckets"]) == 32


def test_sampled_chunked_equals_whole():
    tm = port_model(TINY, jax_model(TINY, seed=11))
    whole = _chunk_phases(_port(tm, **CHUNK_KW), SamplingParams, True)
    for chunk in (8, 16):
        eng = _port(tm, prefill_chunk_tokens=chunk, **CHUNK_KW)
        assert _chunk_phases(eng, SamplingParams, True) == whole
        assert eng.stats()["prefill_chunked_requests"] >= 1


def _whole_phase1(tm, sampled=True):
    eng = _port(tm, **CHUNK_KW)
    return _chunk_phases(eng, SamplingParams, sampled)[0]


def _phase1_requests(eng):
    sp = [SamplingParams(max_new_tokens=8),
          SamplingParams(max_new_tokens=7, temperature=0.9, seed=5),
          SamplingParams(max_new_tokens=8, temperature=1.2, top_k=13,
                         seed=2)]
    return [eng.submit(p, s) for p, s in zip(PROMPTS1, sp)]


def test_mid_prefill_preempt_resumes_at_the_chunk_boundary():
    """Preempting a lane mid-chunked-prefill drops its progress; the
    blocks its chunks adopted survive in the store, so re-admission
    resumes from the boundary as a prefix hit, and the stream stays
    bitwise."""
    tm = port_model(TINY, jax_model(TINY, seed=11))
    whole = _whole_phase1(tm)
    eng = _port(tm, prefill_chunk_tokens=8, **CHUNK_KW)
    reqs = _phase1_requests(eng)
    eng.admit()                  # first chunks
    eng.step()                   # chunk 2: 16 tokens = 4 full blocks
    victim = reqs[0]             # the 26-token prompt, mid-prefill
    assert victim.request_id in eng._chunking
    eng.preempt(victim)
    assert victim.request_id not in eng._chunking
    eng.run()
    assert _outs(reqs) == whole
    assert victim.prefix_hit_tokens >= 16
    assert eng.stats()["preemptions"] == 1


def test_decode_preempt_reprefills_through_chunks():
    """A lane preempted mid-decode re-prefills prompt + generated tokens
    in chunks; the final chunk re-samples the in-flight token, which
    the resume check holds to the one it replaces."""
    tm = port_model(TINY, jax_model(TINY, seed=11))
    whole = _whole_phase1(tm)
    eng = _port(tm, prefill_chunk_tokens=8, **CHUNK_KW)
    reqs = _phase1_requests(eng)
    while not all(r.output_ids for r in reqs):
        eng.step()
    eng.preempt(reqs[0])
    eng.run()
    assert _outs(reqs) == whole
    assert eng.stats()["prefill_chunked_requests"] >= 4


def test_resume_check_raises_on_a_diverged_token():
    tm = port_model(TINY, jax_model(TINY))
    eng = _port(tm, **PREEMPT_KW)
    req = eng.submit([3, 1, 4, 1, 5], SamplingParams(max_new_tokens=6))
    eng.step(horizon=2)
    eng.preempt(req)
    req.output_ids[-1] = (req.output_ids[-1] + 1) % TINY.vocab_size
    with pytest.raises(RuntimeError, match="preemption resume diverged"):
        eng.run()


def test_chunk_size_normalization_and_the_jax_pool_size():
    tm = port_model(TINY, jax_model(TINY))
    assert _port(tm, prefill_chunk_tokens=10, **CHUNK_KW)._chunk_tokens == 16
    assert _port(tm, prefill_chunk_tokens=2, **CHUNK_KW)._chunk_tokens == 8
    with pytest.raises(ValueError):
        _port(tm, prefill_chunk_tokens=-4, **CHUNK_KW)
    # the auto pool: a full row per slot + the prefix headroom + scratch
    jm = jax_model(TINY)
    for kw in ({}, dict(num_slots=2, max_seq_len=64),
               dict(prefix_cache_bytes=0), dict(prefix_block_size=0)):
        eng = _port(tm, **kw)
        jeng = _jax(jm, **kw)
        assert eng.stats()["kv_blocks_capacity"] == jeng.pool.capacity
    assert _port(tm).stats()["kv_blocks_capacity"] > 8 * 16


def test_decode_never_writes_a_shared_block():
    """Frozen and mid-chunk lanes still run every decode step at their
    frozen ``pos``: the blocks the radix store holds must keep their
    bytes across a mixed run's horizons."""
    tm = port_model(TINY, jax_model(TINY, seed=2))
    eng = _port(tm, prefill_chunk_tokens=8, **dict(CHUNK_KW, max_horizon=4))
    eng.generate([BASE], SamplingParams(max_new_tokens=3))   # caches BASE
    reqs = [eng.submit(BASE[:20] + [5, 6, 7], SamplingParams(
                max_new_tokens=12)),
            eng.submit(list(range(1, 30)), SamplingParams(max_new_tokens=9)),
            eng.submit(BASE[:13], SamplingParams(max_new_tokens=2))]
    checked = 0
    while eng.scheduler.has_work:
        eng.admit()
        shared = sorted({n.block for n in _nodes(eng.prefix)})
        snap = [(i, b, eng.pool.k[i][b].clone(), eng.pool.v[i][b].clone())
                for b in shared for i in range(len(eng.pool.k))]
        eng.step(horizon=4)
        for i, b, k, v in snap:
            assert eng.pool.refcount(b) > 0      # nothing evicted meanwhile
            assert torch.equal(eng.pool.k[i][b], k)
            assert torch.equal(eng.pool.v[i][b], v)
            checked += 1
    assert all(r.finish_reason == "length" for r in reqs)
    assert checked > 0 and eng.stats()["prefill_chunked_requests"] >= 2


def _nodes(cache):
    stack, out = [cache._root], []
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        if n is not cache._root:
            out.append(n)
    return out


def _victims(eng, sp_cls, prompts):
    reqs = [eng.submit(p, sp_cls(max_new_tokens=14), priority=pr)
            for p, pr in zip(prompts, (0, 0, 1))]
    victims = []
    orig = eng.preempt
    eng.preempt = lambda r: (victims.append(r.request_id), orig(r))
    eng.run()
    return reqs, victims


def test_preemption_victims_follow_priority_then_age_as_in_jax():
    """Under pressure the lowest priority goes first, the youngest
    within a priority: the first victim is request 1, not the younger
    request 2 of higher priority; the whole sequence is the JAX
    engine's."""
    jm = jax_model(TINY)
    prompts = [[7, 3, 9, 1, 4, 4, 2, 8], [5, 6, 7, 8, 9, 1, 2, 3],
               [2, 4, 6, 8, 1, 3, 5, 7]]
    kw = dict(PREEMPT_KW, num_slots=3, kv_pool_blocks=10)
    jreqs, jvictims = _victims(_jax(jm, **kw), JSamplingParams, prompts)
    reqs, victims = _victims(_port(port_model(TINY, jm), **kw),
                             SamplingParams, prompts)
    assert victims == jvictims and victims[0] == 1
    assert _outs(reqs) == _outs(jreqs)
    assert all(len(r.output_ids) == 14 for r in reqs)


def test_kernel_geometry_check():
    """The geometry the engine checks on the card at construction."""
    check_kernel_geometry(16, 32, 32, 128, torch.bfloat16)
    check_kernel_geometry(16, 32, 8, 64, torch.float32)
    check_kernel_geometry(16, 32, 8, 128, torch.float16)
    with pytest.raises(ValueError, match="block_size"):
        check_kernel_geometry(4, 32, 32, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        check_kernel_geometry(16, 4, 4, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="kv heads"):
        check_kernel_geometry(16, 6, 4, 64, torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        check_kernel_geometry(16, 32, 32, 128, torch.float64)
