"""Speculative decoding in the port's serving engine
(``EngineConfig.spec_k``), on the CPU.

Inside the port every draft width must reproduce the K = 0 stream
bitwise, greedy and seeded-sampled, through EOS and budget cuts inside a
verify window, the adaptive gate, the prefix cache under GQA, chunked
prefill and a preemption mid-draft (the workloads of
``tests/test_serving.py::TestSpeculativeDecode``).  Against the JAX
engine on the same weights: the greedy streams are equal, and since the
drafter and the acceptance rule are the same functions of the same
tokens, so are the spec counters (draft and accepted tokens, the
``accept_len_hist``, the lanes' acceptance EMA).  Sampled streams differ
from JAX's by design (torch generators, not threefry bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.sampling import sample_window as jax_sample_window
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving.sampling import sample_batch, sample_window

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, TINY_GQA, jax_model, one_thread, port_model,
)

REP_PROMPT = [3, 17, 42, 9] * 4             # a repeated pattern
RND_PROMPT = [11, 62, 90, 23, 5, 81, 40, 8]
SPEC_KW = dict(num_slots=2, max_seq_len=48, max_horizon=4)

_MODELS = {}


def _model(cfg=TINY, seed=0):
    """The port's model on the JAX model's weights (cached)."""
    key = (id(cfg), seed)
    if key not in _MODELS:
        _MODELS[key] = port_model(cfg, jax_model(cfg, seed=seed))
    return _MODELS[key]


def _engine(tm, k, adaptive=False, **kw):
    return Engine(tm, EngineConfig(spec_k=k, spec_adaptive=adaptive,
                                   **dict(SPEC_KW, **kw)), device="cpu")


def _run(tm, prompts, sps, k, adaptive=False, **kw):
    eng = _engine(tm, k, adaptive, **kw)
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
    eng.run()
    return reqs, eng


def _outs(reqs):
    return [[int(t) for t in r.output_ids] for r in reqs]


def _params(mode, budgets=(16, 12)):
    if mode == "greedy":
        return [SamplingParams(max_new_tokens=n) for n in budgets]
    return [SamplingParams(max_new_tokens=n, temperature=0.9, top_k=20,
                           top_p=0.9, seed=7 + i)
            for i, n in enumerate(budgets)]


def test_sample_window_draws_token_count_plus_j():
    """Window position j of lane i samples as token counts[i] + j of its
    request: exactly sample_batch's draw for that token at K = 0.  The
    greedy lanes equal JAX's sample_window on the same numpy logits."""
    r = np.random.RandomState(0)
    logits = r.randn(3, 4, 50).astype(np.float32)
    seeds, counts = [3, 9, 4], [0, 5, 11]
    temps, top_ks, top_ps = [0.0, 0.9, 0.7], [0, 20, 0], [1.0, 0.9, 0.8]
    got = sample_window(torch.from_numpy(logits), seeds, counts, temps,
                        top_ks, top_ps)
    assert tuple(got.shape) == (3, 4)
    for j in range(4):
        want = sample_batch(torch.from_numpy(logits[:, j]), seeds,
                            [c + j for c in counts], temps, top_ks, top_ps)
        assert torch.equal(got[:, j], want)
    ref = np.asarray(jax_sample_window(
        jnp.asarray(logits), jnp.asarray(seeds, jnp.uint32),
        jnp.asarray(counts, jnp.int32), jnp.asarray(temps, jnp.float32),
        jnp.asarray(top_ks, jnp.int32), jnp.asarray(top_ps, jnp.float32)))
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    assert torch.equal(sample_window(torch.from_numpy(logits), seeds, counts,
                                     [0.0] * 3, top_ks, top_ps),
                       torch.from_numpy(logits.argmax(-1)))


_K0 = {}


def _k0(mode):
    if mode not in _K0:
        _K0[mode] = _outs(_run(_model(), [REP_PROMPT, RND_PROMPT],
                               _params(mode), 0)[0])
    return _K0[mode]


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_every_draft_width_equals_k0(mode, k):
    reqs, eng = _run(_model(), [REP_PROMPT, RND_PROMPT], _params(mode), k)
    assert _outs(reqs) == _k0(mode)
    assert eng.stats()["spec"]["draft_tokens"] > 0
    assert all(b[2] == k for b in eng.stats()["decode_buckets"])


def test_mid_window_eos():
    """An EOS inside a verify window cuts the emitted run exactly where
    K = 0 decode stops."""
    stream = _k0("greedy")[0][:12]
    idx = next(i for i in range(2, 9) if stream.index(stream[i]) == i)
    sp = SamplingParams(max_new_tokens=12, eos_token_id=stream[idx])
    (req,), _ = _run(_model(), [REP_PROMPT], [sp], 4)
    assert req.output_ids == stream[:idx + 1]
    assert req.finish_reason == "eos"


@pytest.mark.parametrize("budget", [1, 7])
def test_budget_truncation_mid_window(budget):
    (req,), _ = _run(_model(), [REP_PROMPT],
                     [SamplingParams(max_new_tokens=budget)], 4)
    assert req.output_ids == _k0("greedy")[0][:budget]
    assert req.finish_reason == "length"


def test_adaptive_gate_flips_the_dispatch_to_k0():
    """An unreachable acceptance floor turns the lane's gate off after
    its first window; the next dispatches run K = 0, and the stream is
    unchanged through the flip."""
    sp = SamplingParams(max_new_tokens=16)
    (req,), eng = _run(_model(), [RND_PROMPT], [sp], 4, adaptive=True,
                       num_slots=1, spec_accept_floor=1.1)
    assert req.output_ids == _k0("greedy")[1][:12] + req.output_ids[12:]
    (ref,), _ = _run(_model(), [RND_PROMPT], [sp], 0, num_slots=1)
    assert req.output_ids == ref.output_ids
    s = eng.stats()
    assert {b[2] for b in s["decode_buckets"]} == {0, 4}
    assert s["spec"]["lane_accept_ema"][0] < 1.0
    assert not eng._spec_gates[0]


def test_spec_with_prefix_cache_and_gqa():
    tm = _model(TINY_GQA, seed=3)
    prompt = [5, 9, 5, 9, 5, 9, 5, 9]
    sps = [SamplingParams(max_new_tokens=10),
           SamplingParams(max_new_tokens=10, temperature=0.8, seed=3)]
    outs = []
    for k in (0, 4):
        eng = _engine(tm, k, prefix_cache_bytes=1 << 20, prefix_block_size=4)
        eng.generate(prompt, sps[0])                 # caches the prompt
        reqs = [eng.submit(prompt + [7], sp) for sp in sps]
        eng.run()
        assert all(r.prefix_hit_tokens == 8 for r in reqs)
        outs.append(_outs(reqs))
    assert outs[0] == outs[1]


def test_spec_with_chunked_prefill():
    """A 27-token prompt prefilled in chunks of 8 beside a decoding
    request: K = 4 chunked equals K = 0 whole, greedy and sampled."""
    long = [int(t) for t in np.random.RandomState(4).randint(1, 120, 27)]
    prompts = [REP_PROMPT, long]
    sps = [SamplingParams(max_new_tokens=12),
           SamplingParams(max_new_tokens=9, temperature=0.8, seed=5)]

    def staggered(k, chunk):
        eng = _engine(_model(), k, prefill_chunk_tokens=chunk,
                      max_seq_len=64)
        reqs = [eng.submit(prompts[0], sps[0])]
        eng.step()
        reqs.append(eng.submit(prompts[1], sps[1]))
        eng.run()
        return _outs(reqs), eng.stats()

    whole, _ = staggered(0, 0)
    chunked, st = staggered(4, 8)
    assert chunked == whole
    assert st["prefill_chunked_requests"] == 2     # both exceed a chunk
    assert st["spec"]["draft_tokens"] > 0


def test_preempt_mid_draft_resumes_bitwise():
    """Preemption mid-draft: the request re-prefills prompt + its tokens
    but the last, re-samples that one (the resume check), and its stream
    equals a K = 0 run of it alone."""
    tm = _model()
    prompts = [REP_PROMPT, [9, 2, 6, 1]]
    sps = [SamplingParams(max_new_tokens=10),
           SamplingParams(max_new_tokens=10, temperature=0.9, seed=4)]
    alone = [_outs(_run(tm, [p], [sp], 0, num_slots=1)[0])[0]
             for p, sp in zip(prompts, sps)]
    eng = _engine(tm, 4)
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
    eng.step(horizon=2)
    assert 0 < reqs[1].n_generated < 10
    eng.preempt(reqs[1])
    eng.run()
    assert _outs(reqs) == alone
    assert eng.stats()["preemptions"] == 1


_JAX_RUNS = {}


def _jax_spec_run(cfg):
    """The JAX spec engine (K = 4, fixed) on the greedy workload, once
    per config: (streams, stats)."""
    if id(cfg) not in _JAX_RUNS:
        prompts = [[t % cfg.vocab_size for t in p]
                   for p in (REP_PROMPT, RND_PROMPT)]
        eng = JEngine(jax_model(cfg, seed=0), JEngineConfig(
            spec_k=4, spec_adaptive=False, **SPEC_KW),
            register_profiler=False)
        reqs = [eng.submit(p, JSamplingParams(max_new_tokens=n))
                for p, n in zip(prompts, (12, 10))]
        eng.run()
        _JAX_RUNS[id(cfg)] = (prompts, _outs(reqs), eng.stats())
        eng.close()
    return _JAX_RUNS[id(cfg)]


@CONFIGS
def test_greedy_spec_streams_and_counters_match_the_jax_engine(cfg):
    prompts, ref, jstats = _jax_spec_run(cfg)
    reqs, eng = _run(_model(cfg), prompts,
                     [SamplingParams(max_new_tokens=n) for n in (12, 10)], 4)
    assert _outs(reqs) == ref
    s, js = eng.stats()["spec"], jstats["spec"]
    for key in ("k", "adaptive", "ngram", "draft_tokens", "accepted_tokens",
                "accept_len_hist", "lane_accept_ema"):
        assert s[key] == js[key], key
    assert s["accept_rate"] == pytest.approx(js["accept_rate"])
    assert s["mean_accept_len"] == pytest.approx(js["mean_accept_len"])


def test_spec_stats_keys_and_bounds_follow_the_jax_engine():
    _, _, jstats = _jax_spec_run(TINY)
    reqs, eng = _run(_model(), [REP_PROMPT, RND_PROMPT], _params("greedy"),
                     4)
    st = eng.stats()
    spec = st["spec"]
    assert set(spec) == set(jstats["spec"])
    for key in ("spec_draft_tokens", "spec_accepted_tokens",
                "spec_accept_rate", "spec_forced_tokens"):
        assert key in jstats and key in st
    assert st["spec_draft_tokens"] == spec["draft_tokens"] > 0
    assert st["spec_accepted_tokens"] == spec["accepted_tokens"]
    assert 0.0 <= spec["accept_rate"] <= 1.0
    hist = spec["accept_len_hist"]
    assert hist and all(1 <= n <= 5 for n in hist)      # emits 1..K+1
    assert sum(c * (n - 1) for n, c in hist.items()) == \
        spec["accepted_tokens"]
    assert spec["mean_accept_len"] == pytest.approx(
        sum(n * c for n, c in hist.items()) / sum(hist.values()))
    # a K = 0 engine reports no spec activity
    _, eng0 = _run(_model(), [REP_PROMPT], [SamplingParams(
        max_new_tokens=8)], 0)
    s0 = eng0.stats()["spec"]
    assert s0["draft_tokens"] == 0 and s0["accept_len_hist"] == {}
    assert eng0._hist is None


def _shared_blocks(cache):
    stack, out = [cache._root], set()
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        if n is not cache._root:
            out.add(n.block)
    return sorted(out)


def test_decode_never_writes_a_shared_block_with_spec():
    """Rejected draft positions write KV at pos + n_emit .. pos + K, and
    frozen and mid-chunk lanes run every K+1-wide window at their frozen
    pos: the blocks the radix store holds keep their bytes across every
    horizon of a mixed run."""
    rng = np.random.RandomState(11)
    base = [int(t) for t in rng.randint(1, 95, 26)]
    eng = _engine(_model(TINY, seed=2), 4, prefill_chunk_tokens=8,
                  num_slots=4, max_seq_len=64, kv_pool_blocks=96)
    eng.generate([base], SamplingParams(max_new_tokens=3))   # caches base
    reqs = [eng.submit(base[:20] + [5, 6, 7], SamplingParams(
                max_new_tokens=12)),
            eng.submit(list(range(1, 30)), SamplingParams(max_new_tokens=9)),
            eng.submit(base[:13], SamplingParams(max_new_tokens=2))]
    checked = 0
    while eng.scheduler.has_work:
        eng.admit()
        snap = [(i, b, eng.pool.k[i][b].clone(), eng.pool.v[i][b].clone())
                for b in _shared_blocks(eng.prefix)
                for i in range(len(eng.pool.k))]
        eng.step(horizon=4)
        for i, b, k, v in snap:
            assert eng.pool.refcount(b) > 0
            assert torch.equal(eng.pool.k[i][b], k)
            assert torch.equal(eng.pool.v[i][b], v)
            checked += 1
    assert all(r.finish_reason == "length" for r in reqs)
    assert checked > 0 and eng.stats()["prefill_chunked_requests"] >= 2
    assert eng.stats()["spec"]["draft_tokens"] > 0
