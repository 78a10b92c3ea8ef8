"""The port's host KV tier (``paddle_tpu_torch.serving.kv_host_tier``
and the engine's swap paths) against the JAX package's: the arena under
the same call sequence makes the same decisions and keeps the same
``stats()``; the engines on the same TINY / TINY_GQA weights, under
``kv_swap_policy`` "always" and "never", give equal greedy streams and
equal swap counters.  Inside the port: a preempted lane swapped back in
resumes bit for bit as recompute does, greedy and seeded, in the fp and
the int8 pool (the stored bytes equal as integers), under "auto" too;
demoted prefix blocks re-match; a full arena and "never" fall back to
recompute; no host block leaks; a bulk reclaim demotes in one batch."""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import HostKVTier as JHostKVTier
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.serving import (
    Engine, EngineConfig, HostKVTier, SamplingParams,
)

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, jax_model, one_thread, port_model,
)

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6]]
# keys the port's kv_pool block adds to the JAX engine's
PORT_KV_KEYS = {"swap_decisions", "swap_uploads"}
PORT_TIER_KEYS = {"pinned", "host_syncs"}


def _kw(**kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 48)
    kw.setdefault("max_horizon", 4)
    kw.setdefault("prefix_block_size", 4)
    kw.setdefault("prefix_cache_bytes", 1 << 20)
    kw.setdefault("kv_host_bytes", 1 << 20)
    kw.setdefault("kv_swap_policy", "always")
    return kw


def _port(model, **kw):
    return Engine(model, EngineConfig(**_kw(**kw)), device="cpu",
                  register_profiler=False)


@pytest.fixture(scope="module")
def model():
    return port_model(TINY, jax_model(TINY))


def _preempt_run(eng, params):
    """Both lanes decode, both are preempted mid-stream, the run
    finishes through re-admission (a swap-in with the tier, else a
    re-prefill)."""
    reqs = [eng.submit(list(p), s) for p, s in zip(PROMPTS, params)]
    eng.step(horizon=2)
    eng.preempt(reqs[0])
    eng.preempt(reqs[1])
    while eng.scheduler.has_work:
        eng.step()
    return reqs


def _port_params():
    return [SamplingParams(max_new_tokens=10),
            SamplingParams(temperature=0.8, top_k=20, seed=11,
                           max_new_tokens=10)]


# ------------------------------------------------------------ the arena
L, BS, KVH, HD = 2, 4, 2, 8
BPB = 2 * L * BS * KVH * HD * 4


def _blk(x, lib):
    if lib == "np":
        return np.full((L, BS, KVH, HD), x, np.float32)
    return torch.full((L, BS, KVH, HD), float(x))


def _tier_unit_script(tier, lib):
    """tests/test_serving.py's unit sequence; returns every decision."""
    blk = lambda x: _blk(x, lib)
    toks = list(range(12))
    out = [tier.capacity,
           tier.store_prefix(tuple(toks[:4]), blk(1), blk(-1)),
           tier.store_prefix(tuple(toks[:8]), blk(2), blk(-2)),
           tier.blocks_in_use,
           tier.store_prefix(tuple(toks[:4]), blk(9), blk(-9)),
           tier.blocks_in_use, tier.demotions,
           tier.match_prefix(toks[:8] + [99], 0),
           tier.match_prefix(toks[:8], 0), tier.match_prefix(toks[:7], 0),
           tier.match_prefix([99] + toks[1:8], 0)]
    hb = tier.pop_prefix(tuple(toks[:4]))
    k, v, ks, vs = tier.read_block(hb)
    out += [hb, np.asarray(k).tolist(), np.asarray(v).tolist(), ks, vs]
    tier.release(hb)
    payload = [(blk(7), blk(-7), None, None)] * 2
    out += [tier.save_lane("r1", 8, payload), tier.blocks_in_use,
            tier.save_lane("r2", 16, [payload[0]] * 4),
            tier.peek_lane("r2"), tier.blocks_in_use]
    img = tier.take_lane("r1")
    out += [img.n_tokens, img.hbs, tier.peek_lane("r1")]
    for h in img.hbs:
        tier.release(h)
    with pytest.raises(ValueError) as e:
        tier.release(img.hbs[0])
    out += [str(e.value), tier.drop_lane("r1"), tier.blocks_in_use,
            tier.stats()]
    return out


def _pinned_script(tier, lib):
    """tests/test_serving.py's mid-swap spill sequence."""
    blk = lambda x: _blk(x, lib)
    toks = list(range(8))
    out = [tier.store_prefix(tuple(toks[:4]), blk(1), blk(-1)),
           tier.store_prefix(tuple(toks[:8]), blk(2), blk(-2))]
    paths = tier.match_prefix(toks, 0)
    tier.pin_prefix(paths)
    out += [paths, tier.store_prefix((9, 9, 9, 9), blk(3), blk(-3)),
            tier.demotions_dropped]
    for p in paths:
        hb = tier.pop_prefix(p)
        out.append(hb)
        tier.release(hb)
    tier.unpin_prefix(paths)
    out += [tier.blocks_in_use,
            tier.store_prefix(tuple(toks[:4]), blk(4), blk(-4))]
    stale = tier.match_prefix(toks[:5], 0)
    out += [stale, tier.store_prefix((7, 7, 7, 7), blk(5), blk(-5)),
            tier.store_prefix((6, 6, 6, 6), blk(6), blk(-6)),
            tier.prefix_evictions, tier.pop_prefix(stale[0])]
    tier.pin_prefix([(7, 7, 7, 7)])
    out += [tier.store_prefix((5, 5, 5, 5), blk(7), blk(-7)),
            tier.pop_prefix((6, 6, 6, 6))]
    hb = tier.pop_prefix((7, 7, 7, 7))
    out.append(hb)
    tier.release(hb)
    tier.unpin_prefix([(7, 7, 7, 7)])
    out.append(tier.stats())
    return out


def _strip(stats):
    return {k: v for k, v in stats.items()
            if k not in PORT_TIER_KEYS | {"store_dtype"}}


@pytest.mark.parametrize("script,blocks", [(_tier_unit_script, 3),
                                           (_pinned_script, 2)],
                         ids=["unit", "pinned_midswap_spill"])
def test_arena_decisions_and_stats_equal_jax(script, blocks):
    jt = JHostKVTier(L, BS, KVH, HD, np.float32,
                     budget_bytes=blocks * BPB, bytes_per_block=BPB)
    tt = HostKVTier(L, BS, KVH, HD, torch.float32,
                    budget_bytes=blocks * BPB, bytes_per_block=BPB)
    want, got = script(jt, "np"), script(tt, "torch")
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, dict):
            assert _strip(a) == _strip(b), i
            assert a["store_dtype"] == b["store_dtype"] == "float32"
            assert a["pinned"] is False and a["host_syncs"] == 0
        else:
            assert a == b, (i, a, b)


def test_arena_nbytes_dtypes_and_gather():
    tier = HostKVTier(L, BS, KVH, HD, torch.bfloat16,
                      budget_bytes=4 * BPB, bytes_per_block=BPB)
    assert tier.k.dtype == torch.bfloat16 and tier.k_scale is None
    assert tier.nbytes == 2 * 4 * L * BS * KVH * HD * 2
    q = HostKVTier(L, BS, KVH, HD, torch.int8, budget_bytes=4 * BPB,
                   bytes_per_block=BPB, quantized=True)
    x = torch.randint(-127, 128, (L, BS, KVH, HD), dtype=torch.int8)
    s = torch.rand(L, BS)
    assert q.store_prefix((1, 2, 3, 4), x, -x, s, 2 * s)
    k, v, ks, vs = q.gather([q.pop_prefix((1, 2, 3, 4))])
    assert torch.equal(k[0], x) and torch.equal(v[0], -x)
    assert torch.equal(ks[0], s) and torch.equal(vs[0], 2 * s)
    assert k.data_ptr() == q.k[0].data_ptr()      # a run: arena views
    assert not q.is_pinned()
    # rows out of order are staged into fresh buffers
    assert q.store_prefix((5, 6, 7, 8), -x, x, 3 * s, s)
    k, v, ks, vs = q.gather([1, 0])
    assert k.data_ptr() != q.k[1].data_ptr()
    assert torch.equal(k[0], -x) and torch.equal(k[1], x)
    assert torch.equal(ks[0], 3 * s) and torch.equal(vs[1], 2 * s)


# --------------------------------------------- the engines, JAX oracle
@CONFIGS
@pytest.mark.parametrize("policy", ["always", "never"])
def test_swap_counters_and_streams_equal_jax(cfg, policy):
    jm = jax_model(cfg, seed=0)
    jeng = JEngine(jm, JEngineConfig(program_cards=False,
                                     **_kw(kv_swap_policy=policy)),
                   register_profiler=False)
    eng = Engine(port_model(cfg, jm),
                 EngineConfig(**_kw(kv_swap_policy=policy)), device="cpu",
                 register_profiler=False)
    jr = _preempt_run(jeng, [JSamplingParams(max_new_tokens=10)] * 2)
    pr = _preempt_run(eng, [SamplingParams(max_new_tokens=10)] * 2)
    assert [[int(t) for t in r.output_ids] for r in jr] == \
        [r.output_ids for r in pr]
    jc, c = jeng.counters(), eng.counters()
    for k in ("kv_swap_ins", "kv_swap_outs", "kv_swap_in_bytes",
              "kv_swap_out_bytes", "preemptions", "prefix_hit_tokens",
              "prefill_calls", "decode_steps", "kv_blocks_in_use"):
        assert c[k] == jc[k], (k, c[k], jc[k])
    if policy == "always":
        assert c["kv_swap_ins"] >= 1 and c["kv_swap_outs"] >= 1
    else:
        assert c["kv_swap_ins"] == c["kv_swap_outs"] == 0
    jkv, kv = jeng.stats()["kv_pool"], eng.stats()["kv_pool"]
    assert set(kv) - set(jkv) == PORT_KV_KEYS
    for k in (set(jkv) & set(kv)) - {"dtype", "host_tier"}:
        assert kv[k] == jkv[k], (k, kv[k], jkv[k])
    assert _strip(kv["host_tier"]) == _strip(jkv["host_tier"])
    assert eng.stats()["prefix"] == jeng.stats()["prefix"]
    for e in (jeng, eng):
        e.drain()
    assert eng.stats()["kv_pool"]["host_blocks_in_use"] == 0
    jeng.close()
    eng.close()


def test_demoted_prefix_rematch_equals_jax():
    """A tight radix budget and churn evict a warm prompt's chain; with
    the tier the eviction is a demotion and the later identical prompt
    re-matches, in both engines alike and at least as well as a
    never-evicted control."""
    P = [5, 5, 7, 7, 1, 2, 3, 4, 9, 8, 7, 6, 1, 3, 5, 7, 2, 4, 6, 8]
    churn = [[c] * 12 for c in (11, 22, 33)]

    def warm_probe(eng, sp):
        for q in [P] + churn:
            eng.submit(list(q), sp)
            while eng.scheduler.has_work:
                eng.step()
        r = eng.submit(list(P), sp)
        while eng.scheduler.has_work:
            eng.step()
        return r

    jm = jax_model(TINY, seed=0)
    m = port_model(TINY, jm)
    ctrl = _port(m, kv_host_bytes=0)
    bpb = ctrl.pool.bytes_per_block
    ctrl_hit = warm_probe(ctrl, SamplingParams(max_new_tokens=4)) \
        .prefix_hit_tokens
    ctrl.close()
    eng = _port(m, prefix_cache_bytes=8 * bpb)
    jeng = JEngine(jm, JEngineConfig(program_cards=False,
                                     **_kw(prefix_cache_bytes=8 * bpb)),
                   register_profiler=False)
    probe = warm_probe(eng, SamplingParams(max_new_tokens=4))
    jprobe = warm_probe(jeng, JSamplingParams(max_new_tokens=4))
    st, jst = eng.stats(), jeng.stats()
    assert st["prefix"]["evictions_demoted"] > 0
    assert st["kv_pool"]["host_tier"]["promotions"] > 0
    assert probe.prefix_hit_tokens >= ctrl_hit > 0
    assert probe.prefix_hit_tokens == jprobe.prefix_hit_tokens
    assert probe.output_ids == [int(t) for t in jprobe.output_ids]
    assert st["prefix"] == jst["prefix"]
    assert _strip(st["kv_pool"]["host_tier"]) == \
        _strip(jst["kv_pool"]["host_tier"])
    eng.drain()
    assert eng.stats()["kv_pool"]["host_blocks_in_use"] == 0
    eng.close()
    jeng.close()


# ------------------------------------------------------ inside the port
@pytest.mark.parametrize("policy", ["always", "auto"])
def test_preempt_swap_in_resume_bitwise(model, policy):
    """Greedy and seeded lanes preempted mid-decode finish bit for bit
    as the recompute engine's; the traces restate the swap counters and
    drain leaves no host block."""
    ref = _port(model, kv_host_bytes=0)
    r0 = _preempt_run(ref, _port_params())
    ref.close()
    eng = _port(model, kv_swap_policy=policy)
    r1 = _preempt_run(eng, _port_params())
    assert [r.output_ids for r in r1] == [r.output_ids for r in r0]
    c = eng.counters()
    assert c["kv_swap_outs"] >= 1 and c["kv_swap_ins"] >= 1
    tcs = [r.trace.counts() for r in r1]
    assert sum(t["swap_outs"] for t in tcs) == c["kv_swap_outs"]
    assert sum(t["swap_ins"] for t in tcs) == c["kv_swap_ins"]
    assert sum(t["swap_out_bytes"] for t in tcs) == c["kv_swap_out_bytes"]
    assert sum(t["swap_in_bytes"] for t in tcs) == c["kv_swap_in_bytes"]
    kv = eng.stats()["kv_pool"]
    assert kv["swap_decisions"]["swap"] >= 2
    assert kv["swap_uploads"] == c["kv_swap_ins"]
    eng.drain()
    kv = eng.stats()["kv_pool"]
    assert kv["host_blocks_in_use"] == 0
    assert kv["kv_swaps_averted_tokens"] > 0
    eng.close()


def test_int8_roundtrip_stored_bytes_identical(model):
    """An int8 pool swaps at its quantized density: the re-bound blocks'
    payload and scale bytes after the round trip equal the pre-preempt
    ones as integers, and the resumed stream equals recompute's."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    samp = SamplingParams(temperature=0.8, top_k=20, seed=11,
                          max_new_tokens=16)
    ref = _port(model, kv_host_bytes=0, kv_cache_dtype="int8")
    r0 = ref.submit(list(prompt), samp)
    ref.step(horizon=4)
    ref.preempt(r0)
    while ref.scheduler.has_work:
        ref.step()
    ref.close()
    eng = _port(model, kv_cache_dtype="int8")
    r = eng.submit(list(prompt), samp)
    eng.step(horizon=4)
    slot, bs = r.slot, eng._block_size
    pos = int(eng._pos[slot])
    nb = -(-pos // bs)
    bids = [int(eng.cache.tables[slot][j]) for j in range(nb)]
    before = [t.clone() for t in eng._fetch_blocks(bids)]
    eng.preempt(r)
    assert eng.host_tier.stats()["lane_images"] == 1
    assert eng._swap_in(r)
    toks = eng._admission_tokens(r)
    chain = eng.prefix._walk(toks, len(toks))
    fb = pos // bs
    assert len(chain) == fb
    after = eng._fetch_blocks([n.block for n in chain])
    assert after[0].dtype == torch.int8
    for a, b in zip(after, before):
        ints = torch.int8 if a.dtype == torch.int8 else torch.int32
        assert torch.equal(a.view(ints), b[:fb].view(ints))
    while eng.scheduler.has_work:
        eng.step()
    assert r.output_ids == r0.output_ids
    eng.drain()
    assert eng.stats()["kv_pool"]["host_blocks_in_use"] == 0
    eng.close()


@pytest.mark.parametrize("kw", [dict(kv_host_bytes=1),
                                dict(kv_swap_policy="never")],
                         ids=["arena_full", "never"])
def test_arena_exhaustion_and_policy_never_fall_back(model, kw):
    ref = _port(model, kv_host_bytes=0)
    r0 = _preempt_run(ref, _port_params())
    ref.close()
    eng = _port(model, **kw)
    rs = _preempt_run(eng, _port_params())
    assert [r.output_ids for r in rs] == [r.output_ids for r in r0]
    c = eng.counters()
    assert c["kv_swap_ins"] == 0 and c["kv_swap_outs"] == 0
    if "kv_host_bytes" in kw:
        assert eng.host_tier.capacity == 0
    else:
        assert eng.stats()["kv_pool"]["swap_decisions"]["recompute"] >= 2
    eng.drain()
    assert eng.stats()["kv_pool"]["host_blocks_in_use"] == 0
    eng.close()
    with pytest.raises(ValueError, match="kv_swap_policy"):
        _port(model, kv_swap_policy="sometimes")
    with pytest.raises(ValueError, match="kv_host_bytes"):
        _port(model, kv_host_bytes=-1)


def test_host_block_leak_invariant(model):
    eng = _port(model)
    reqs = [eng.submit(list(p), s) for p, s in zip(PROMPTS, _port_params())]
    eng.step(horizon=2)
    eng.preempt(reqs[1])
    assert eng.host_tier.stats()["lane_images"] == 1
    eng.abort(reqs[1])
    eng.submit([7, 7, 7, 7, 2], SamplingParams(max_new_tokens=6))
    while eng.scheduler.has_work:
        eng.step()
    eng.drain()
    s = eng.stats()["kv_pool"]
    assert s["host_blocks_in_use"] == 0
    assert s["host_tier"]["lane_images"] == 0
    assert s["host_tier"]["lane_drops"] >= 1
    eng.close()


def test_bulk_reclaim_batches_demotion_copies(model):
    eng = _port(model)
    assert eng.prefix.spill_batch is not None
    eng.generate([5, 5, 7, 7, 1, 2, 3, 4, 9, 8, 7, 6],
                 SamplingParams(max_new_tokens=4))
    held = eng.prefix._held
    assert held > 1
    calls = []
    orig = eng._fetch_blocks
    eng._fetch_blocks = lambda bids: calls.append(list(bids)) or orig(bids)
    try:
        assert eng.prefix.reclaim(held) == held
    finally:
        eng._fetch_blocks = orig
    assert len(calls) == 1 and len(calls[0]) > 1
    st = eng.stats()
    assert st["prefix"]["evictions_demoted"] >= len(calls[0])
    assert st["kv_pool"]["host_tier"]["demotions"] >= len(calls[0])
    assert st["kv_pool"]["kv_demote_bytes"] == \
        st["prefix"]["evictions_demoted"] * eng.pool.bytes_per_block
    eng.drain()
    assert eng.stats()["kv_pool"]["host_blocks_in_use"] == 0
    eng.close()
