"""The port's int8 serving knobs (``EngineConfig(weight_dtype="int8",
kv_cache_dtype="int8")``) on the CPU, against the JAX package on the
same numpy inputs and weights, and on the workloads of
``tests/test_serving.py::TestQuantServing``.

The quantizers are the same f32 arithmetic in both frameworks, so their
int8 payloads are held equal exactly; ``paged_write_quant`` too.
Against the JAX w8kv8 engine the greedy streams are equal and the
prefill logits agree within ``W8KV8_LOGIT_ATOL``.  Within one quant
config the port's scheduling guarantees hold bitwise (batched and
preempted = sequential, spec K = 4 = K = 0); across configs the greedy
streams agree on a mean longest-common-prefix fraction of at least 0.75
(JAX's own threshold: PTQ may flip a near-tie argmax, after which greedy
streams part for good).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.quantization.serving import (
    channelwise_scales as jax_channelwise_scales,
    quantize_weight as jax_quantize_weight,
)
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving.kv_cache import PagedKV as JPagedKV
from paddle_tpu.serving.kv_cache import PagedKVPool as JPagedKVPool
from paddle_tpu.serving.kv_cache import paged_write_quant as jax_write_quant
from paddle_tpu.serving.paged_attention import _xla_paged_attention
from paddle_tpu_torch.quantization import (
    QuantizedWeight, channelwise_scales, dequantize_weight,
    quantize_for_serving, quantize_weight,
)
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving.kv_cache import (
    PagedKVCache, PagedKVPool, paged_write_quant,
)
from paddle_tpu_torch.serving.paged_attention import paged_attention_plain

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, jax_model, jax_state, one_thread, port_model,
)

# prefill logits of the port's w8kv8 engine against JAX's on the same
# int8 weights, in f32: the products and the attention sum in another
# order (~1e-7 at these inputs; logits are O(0.1)), as the fp port tests'
# 1e-4.  A k/v element within that noise of a rounding boundary of its
# token's int8 step would store one step apart in the two pools and move
# the logits past it; at these seeded inputs none does
W8KV8_LOGIT_ATOL = 1e-4


def test_quantize_weight_matches_jax_up_to_the_transpose():
    """Both Linears store [in, out] and scale per output column (axis 0
    reduced): there is no transpose left, and payloads and scales are
    equal bit for bit."""
    r = np.random.RandomState(0)
    w = (r.randn(48, 80) * 0.05).astype(np.float32)        # [in, out]
    w[:, 3] *= 40.0                                          # an outlier column
    jq, js = jax_quantize_weight(jnp.asarray(w))
    q, s = quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and tuple(s.shape) == (1, 80)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        channelwise_scales(torch.from_numpy(w)).numpy(),
        np.asarray(jax_channelwise_scales(jnp.asarray(w))))


def test_zero_channel_scale_floor():
    """An all-zero output channel quantizes without NaN: the 1e-8 floor
    is applied per channel before the divide."""
    w = torch.zeros(8, 4)                        # [in, out]
    w[:, 1:] = 3.0                               # output channel 0 all zero
    scale = channelwise_scales(w)[0]
    assert torch.isfinite(scale).all() and (scale > 0).all()
    assert scale[0].item() == pytest.approx(1e-8 / 127.0)
    assert scale[1].item() == pytest.approx(3.0 / 127.0)
    q, s = quantize_weight(w)
    dq = dequantize_weight(q, s)
    assert torch.isfinite(dq).all()
    assert (dq[:, 0] == 0).all()
    torch.testing.assert_close(dq[:, 1:], torch.full((8, 3), 3.0), rtol=0,
                               atol=3.0 / 254.0)


def test_dequantize_rounds_once_to_the_dtype():
    q = torch.randint(-127, 128, (16, 8), dtype=torch.int8)
    s = torch.rand(16, 1)
    for dtype in (torch.float32, torch.bfloat16):
        out = dequantize_weight(q, s, dtype)
        assert out.dtype == dtype
        assert torch.equal(out, (q.float() * s).to(dtype))


def test_quantize_for_serving_takes_every_linear():
    """Every projection (q/k/v/o, gate/up/down) of every layer and the LM
    head, under its state_dict name; embeddings and norms stay."""
    tm = port_model(TINY, jax_model(TINY))
    qmap = quantize_for_serving(tm)
    assert len(qmap) == 7 * TINY.num_hidden_layers + 1
    sd = tm.state_dict()
    for name, qw in qmap.items():
        assert isinstance(qw, QuantizedWeight) and qw.dtype == sd[name].dtype
        err = (sd[name] - qw.dequantize()).abs()
        assert (err <= qw.scale / 2 + 1e-9).all()
        assert qw.nbytes == qw.q.numel() + 4 * qw.scale.numel()
    assert not any("embed" in n or "norm" in n for n in qmap)


@pytest.mark.parametrize("s", [1, 5])
def test_paged_write_quant_matches_jax_bitwise(s):
    """Per-token absmax quantize-at-append: the int8 payload and the
    scales equal JAX's; a zero token stores exact zeros; writes past the
    table's coverage land in scratch."""
    r = np.random.RandomState(s)
    b, h, d, bs = 2, 2, 8, 4
    new = r.randn(b, s, h, d).astype(np.float32)
    new[0, 0] = 0.0                                       # a zero token
    tables = np.array([[1, 2], [3, 0]], np.int32)
    pos = np.array([2, 3], np.int32)
    pool = np.zeros((5, bs, h, d), np.int8)
    scales = np.zeros((5, bs), np.float32)
    jp, js = jax_write_quant(jnp.asarray(pool), jnp.asarray(scales),
                             jnp.asarray(new), jnp.asarray(tables),
                             jnp.asarray(pos))
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy())
    out = paged_write_quant(tp, ts, torch.from_numpy(new),
                            torch.from_numpy(tables), torch.from_numpy(pos))
    assert out[0] is tp and out[1] is ts                  # in place
    # scratch block 0 takes colliding garbage writes: compare the rest
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(ts.numpy()[1:], np.asarray(js)[1:])
    assert (tp[1, 2] == 0).all()                          # the zero token


@pytest.mark.parametrize("s", [1, 5])
def test_plain_int8_paged_attention_matches_xla_reference(s):
    """The port's plain paged attention over an int8 pool with scales
    against JAX's ``_xla_paged_attention``: 1e-5 (f32 on both sides), and
    invariant to scratch columns appended to the table."""
    r = np.random.RandomState(3)
    b, qh, kh, d, bs, nb = 2, 4, 2, 8, 4, 3
    q = r.randn(b, s, qh, d).astype(np.float32)
    n = 1 + b * nb
    k = r.randint(-127, 128, (n, bs, kh, d)).astype(np.int8)
    v = r.randint(-127, 128, (n, bs, kh, d)).astype(np.int8)
    ks = (r.rand(n, bs) * 0.05 + 1e-3).astype(np.float32)
    vs = (r.rand(n, bs) * 0.05 + 1e-3).astype(np.float32)
    tables = (1 + np.arange(b * nb, dtype=np.int32)).reshape(b, nb)
    pos = np.array([5, 9 - s], np.int32)
    arrays = (q, k, v, tables, pos, ks, vs)
    want = np.asarray(_xla_paged_attention(*map(jnp.asarray, arrays)))
    t = [torch.from_numpy(a) for a in arrays]
    got = paged_attention_plain(*t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    wide = torch.cat([t[3], torch.zeros(b, 4, dtype=torch.int32)], 1)
    assert torch.equal(paged_attention_plain(t[0], t[1], t[2], wide, *t[4:]),
                       got)


def test_pool_bytes_per_block_accounting():
    """int8 storage charges the payload plus the 4-byte scale of each
    token, as JAX's pool does."""
    mk = dict(num_layers=2, num_blocks=4, block_size=4, kv_heads=2,
              head_dim=8)
    fp = PagedKVPool(**mk, device="cpu")
    q8 = PagedKVPool(**mk, device="cpu", quant_dtype="int8")
    assert fp.bytes_per_block == JPagedKVPool(**mk).bytes_per_block \
        == 2 * 2 * 4 * (2 * 8 * 4)
    assert q8.bytes_per_block == JPagedKVPool(
        **mk, quant_dtype="int8").bytes_per_block == 2 * 2 * 4 * (2 * 8 + 4)
    assert q8.k[0].dtype == torch.int8 and tuple(q8.k_scale[0].shape) == (4, 4)
    assert (q8.k_scale[0] == 0).all() and fp.k_scale is None
    with pytest.raises(ValueError, match="quant_dtype"):
        PagedKVPool(**mk, device="cpu", quant_dtype="fp8")


def test_cow_copy_carries_the_scales():
    """A copy-on-write copies an int8 block's per-token scales with its
    payload, in every layer."""
    cache = PagedKVCache(num_layers=2, num_slots=1, max_seq_len=8,
                         block_size=4, kv_heads=2, head_dim=8, num_blocks=5,
                         device="cpu", quant_dtype="int8")
    pool = cache.pool
    g = torch.Generator().manual_seed(0)
    for buf in pool.k + pool.v:
        buf[1] = torch.randint(-127, 128, buf[1].shape, generator=g,
                               dtype=torch.int8)
    for buf in pool.k_scale + pool.v_scale:
        buf[1] = torch.rand(4, generator=g)
    cache.copy_blocks(torch.tensor([1, 0]), torch.tensor([3, 0]))
    for buf in pool.k + pool.v + pool.k_scale + pool.v_scale:
        assert torch.equal(buf[3], buf[1]) and buf[1].any()


def test_int8_prefix_hit_with_a_cow_tail_equals_no_cache():
    """Prompts sharing 10 tokens over blocks of 4: two full blocks
    leased and a 2-token COW tail, in an int8 pool; the streams equal a
    cacheless engine's, greedy and sampled."""
    tm = port_model(TINY, jax_model(TINY, seed=4))
    shared = [7, 3, 9, 1, 4, 4, 2, 8, 5, 6]
    prompts = [shared + [11, 12], shared + [13], shared + [1, 2, 3]]
    sps = [SamplingParams(max_new_tokens=6),
           SamplingParams(max_new_tokens=6, temperature=0.8, seed=1),
           SamplingParams(max_new_tokens=6)]
    outs = []
    for budget in (1 << 20, 0):
        eng = Engine(tm, EngineConfig(
            num_slots=2, max_seq_len=32, prefix_block_size=4,
            prefix_cache_bytes=budget, kv_cache_dtype="int8",
            weight_dtype="int8"), device="cpu")
        first = eng.submit(prompts[0], sps[0])
        eng.run()
        reqs = [first] + [eng.submit(p, sp)
                          for p, sp in zip(prompts[1:], sps[1:])]
        eng.run()
        outs.append([r.output_ids for r in reqs])
        if budget:
            assert [r.prefix_hit_tokens for r in reqs] == [0, 10, 10]
            assert eng.stats()["cow_copies"] == 2
    assert outs[0] == outs[1]


def test_quant_knobs_normalize_and_size_the_pool_like_jax():
    norm = Engine._norm_quant_knob
    for off in (None, "", "none", "NONE"):
        assert norm(off, "weight_dtype") is None
    for on in ("int8", "INT8", "i8"):
        assert norm(on, "weight_dtype") == "int8"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        norm("fp8", "kv_cache_dtype")
    jm = jax_model(TINY)
    tm = port_model(TINY, jm)
    kw = dict(num_slots=2, max_seq_len=32, prefix_cache_bytes=1 << 16)
    for knobs in ({}, dict(kv_cache_dtype="int8"), dict(weight_dtype="int8")):
        eng = Engine(tm, EngineConfig(**kw, **knobs), device="cpu")
        jeng = JEngine(jm, JEngineConfig(**kw, **knobs),
                       register_profiler=False)
        st, js = eng.stats(), jeng.stats()
        assert st["kv_blocks_capacity"] == jeng.pool.capacity
        for key in ("bytes_per_block", "dtype", "quant_dtype"):
            assert st["kv_pool"][key] == js["kv_pool"][key], key
        for key in ("weight_dtype", "kv_cache_dtype", "quantized_weights",
                    "weight_bytes"):
            assert st["quant"][key] == js["quant"][key], key
        jeng.close()


def _jax_views(pool, tables, pos):
    return [JPagedKV(pool.k[i], pool.v[i], tables, pos, pool.k_scale[i],
                     pool.v_scale[i]) for i in range(len(pool.k))]


@CONFIGS
def test_w8kv8_engine_matches_the_jax_engine(cfg):
    """Greedy streams of the two w8kv8 engines on the same weights are
    equal, and the prefill logits of a two-lane window agree within
    W8KV8_LOGIT_ATOL."""
    jm = jax_model(cfg, seed=1)
    tm = port_model(cfg, jm)
    kw = dict(num_slots=2, max_seq_len=48, max_horizon=4,
              weight_dtype="int8", kv_cache_dtype="int8")
    r = np.random.RandomState(7)
    prompts = [r.randint(0, cfg.vocab_size, n).tolist() for n in (9, 14, 5)]
    jeng = JEngine(jm, JEngineConfig(**kw), register_profiler=False)
    ref = [list(map(int, o)) for o in jeng.generate(
        prompts, JSamplingParams(max_new_tokens=10))]
    eng = Engine(tm, EngineConfig(**kw), device="cpu")
    got = eng.generate(prompts, SamplingParams(max_new_tokens=10))
    assert got == ref

    # one prefill forward over fresh pools: lanes of 9 and 14 tokens
    ids = np.zeros((2, 16), np.int64)
    ids[0, :9], ids[1, :14] = prompts[0], prompts[1]
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos = np.zeros(2, np.int32)
    jpool = JPagedKVPool(cfg.num_hidden_layers, 9, 4, cfg.kv_heads,
                         cfg.head_dim, quant_dtype="int8")
    jlog, _ = jeng._run_model(
        jeng._state_arrays, jnp.asarray(ids),
        _jax_views(jpool, jnp.asarray(tables), jnp.asarray(pos)))
    jeng.close()
    tpool = PagedKVPool(cfg.num_hidden_layers, 9, 4, cfg.kv_heads,
                        cfg.head_dim, device="cpu", quant_dtype="int8")
    eng.cache.pool = tpool
    tlog = eng._forward(torch.from_numpy(ids), torch.from_numpy(tables),
                        torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy()[0, :9], np.asarray(jlog)[0, :9],
                               rtol=0, atol=W8KV8_LOGIT_ATOL)
    np.testing.assert_allclose(tlog.numpy()[1, :14],
                               np.asarray(jlog)[1, :14], rtol=0,
                               atol=W8KV8_LOGIT_ATOL)


def _lcp(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n / max(1, len(a))


def test_w8kv8_batching_preemption_and_prefix_hits():
    """JAX's TestQuantServing workload (a 12-token shared system prompt,
    four requests, a 12-block pool): inside int8 the batched run with
    preemptions and prefix hits equals sequential single runs bitwise;
    spelled-out "off" knobs equal the defaults bitwise; the greedy
    streams agree with fp on a mean LCP fraction >= 0.75."""
    tm = port_model(TINY, jax_model(TINY))
    system = list(range(1, 13))
    prompts = [system + [20 + i, 40 + i] for i in range(4)]
    sp = SamplingParams(max_new_tokens=12)

    def run(wq, kq):
        eng = Engine(tm, EngineConfig(
            num_slots=2, max_seq_len=48, max_horizon=4,
            prefix_block_size=4, kv_pool_blocks=12,
            weight_dtype=wq, kv_cache_dtype=kq), device="cpu")
        reqs = [eng.submit(list(p), sp) for p in prompts]
        eng.run()
        return [r.output_ids for r in reqs], eng.stats()

    fp_out, fp_c = run(None, None)
    off_out, _ = run("none", "")
    assert off_out == fp_out
    q_out, q_c = run("int8", "int8")
    for c in (fp_c, q_c):
        assert c["preemptions"] >= 1 and c["prefix_hit_tokens"] > 0
    assert q_c["kv_pool"]["bytes_per_block"] < fp_c["kv_pool"][
        "bytes_per_block"]
    eng = Engine(tm, EngineConfig(
        num_slots=1, max_seq_len=48, max_horizon=4, prefix_block_size=0,
        weight_dtype="int8", kv_cache_dtype="int8"), device="cpu")
    assert q_out == [eng.generate(list(p), sp) for p in prompts]
    match = sum(_lcp(a, b) for a, b in zip(fp_out, q_out)) / len(fp_out)
    assert match >= 0.75, match


@pytest.mark.parametrize("kq", [None, "int8"], ids=["w8", "w8kv8"])
def test_spec_decode_bitwise_under_quant(kq):
    """Spec K = 4 equals K = 0 bitwise with int8 weights, and int8 KV:
    the verify window reads the same stored int8 bytes a K = 0 step
    would have written."""
    tm = port_model(TINY, jax_model(TINY))
    prompt = [5, 6, 7, 8] * 4
    sps = [SamplingParams(max_new_tokens=16),
           SamplingParams(max_new_tokens=16, temperature=0.8, seed=2)]
    outs = []
    for k in (0, 4):
        eng = Engine(tm, EngineConfig(
            num_slots=2, max_seq_len=64, max_horizon=4, spec_k=k,
            spec_adaptive=False, weight_dtype="int8", kv_cache_dtype=kq),
            device="cpu")
        outs.append(eng.generate([prompt, prompt[3:]], sps))
    assert outs[0] == outs[1]
