"""The port's Transformer decoder half (``TransformerDecoderLayer``,
``TransformerDecoder``, ``Transformer``, the ``Cache``/``StaticCache``
incremental decoding and ``generate_square_subsequent_mask``) against the
JAX package's ``nn.Transformer`` on the same weights
(``convert.state_from_jax``), d_model 32, 4 heads, 2 + 2
layers, f32, numpy-seeded inputs, in eval mode.

Tolerance: f32 on both sides in another summation order through four
layers: 2e-5 of the largest value.  Incremental decoding against the
full forward inside the port: the same f32 math over other shapes
(q_len 1 against a masked window), 2e-5 of the largest value.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import state_from_jax

from _torch_port_util import one_thread  # noqa: F401

DIMS = dict(d_model=32, num_encoder_layers=2, num_decoder_layers=2,
            dim_feedforward=64)


def _models(normalize_before=False):
    paddle.seed(0)
    jm = jnn.Transformer(nhead=4, dropout=0.0,
                         normalize_before=normalize_before, **DIMS)
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tnn.Transformer(nhead=4, dropout=0.0,
                         normalize_before=normalize_before, device="cpu",
                         **DIMS)
    tm.load_state_dict(state_from_jax(state, tm, device="cpu"))
    tm.eval()
    return jm, tm


def _near(got, want, frac=2e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    if isinstance(want, torch.Tensor):
        want = want.detach()
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


def _data(seed=0, b=2, s=7, t=5):
    r = np.random.RandomState(seed)
    src = r.randn(b, s, 32).astype(np.float32)
    tgt = r.randn(b, t, 32).astype(np.float32)
    pad = np.ones((b, 1, 1, s), bool)
    pad[1, ..., s - 2:] = False              # sequence 1: 2 padded keys
    return src, tgt, pad


def test_mask_equals_jax():
    want = jnn.Transformer.generate_square_subsequent_mask(6).numpy()
    got = tnn.Transformer.generate_square_subsequent_mask(6, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_norm", "pre_norm"])
def test_forward_matches_jax(normalize_before):
    """Transformer.forward with a source key-padding mask on the encoder
    and the cross-attention and the causal mask on the target."""
    jm, tm = _models(normalize_before)
    src, tgt, pad = _data()
    t = tgt.shape[1]
    mask = jnn.Transformer.generate_square_subsequent_mask(t)
    want = jm(paddle.to_tensor(src), paddle.to_tensor(tgt),
              paddle.to_tensor(pad), mask, paddle.to_tensor(pad))
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt),
             torch.from_numpy(pad),
             tnn.Transformer.generate_square_subsequent_mask(t, "cpu"),
             torch.from_numpy(pad))
    _near(got, want)


def test_incremental_decode_equals_full_forward_and_jax():
    """The decoder's Cache / StaticCache loop, one target position a
    step, equals the full masked forward (the port's and JAX's), and
    each step's caches grow along axis 1 (self) or stay (cross)."""
    jm, tm = _models()
    src, tgt, _ = _data(seed=1)
    t = tgt.shape[1]
    memory = tm.encoder(torch.from_numpy(src))
    full = tm.decoder(torch.from_numpy(tgt), memory,
                      tnn.Transformer.generate_square_subsequent_mask(
                          t, "cpu"))
    jmem = jm.encoder(paddle.to_tensor(src))
    jfull = jm.decoder(paddle.to_tensor(tgt), jmem,
                       jnn.Transformer.generate_square_subsequent_mask(t))
    _near(full, jfull)
    cache = tm.decoder.gen_cache(memory)
    steps = []
    for i in range(t):
        out, cache = tm.decoder(torch.from_numpy(tgt[:, i:i + 1]), memory,
                                None, None, cache)
        steps.append(out)
        for inc, static in cache:
            assert isinstance(inc, tnn.MultiHeadAttention.Cache)
            assert isinstance(static, tnn.MultiHeadAttention.StaticCache)
            assert inc.k.shape[1] == i + 1
            assert static.k.shape[1] == src.shape[1]
    _near(torch.cat(steps, 1), full)


def test_mha_caches_match_jax():
    """MultiHeadAttention with a Cache (self-attention one step at a
    time) and a StaticCache (precomputed k, v) against JAX's layer."""
    jm, tm = _models()
    ja = jm.decoder.layers[0].self_attn
    ta = tm.decoder.layers[0].self_attn
    x = np.random.RandomState(2).randn(1, 3, 32).astype(np.float32)
    mem = np.random.RandomState(3).randn(1, 6, 32).astype(np.float32)
    jc = ja.gen_cache(paddle.to_tensor(x[:, :0]))
    tc = ta.gen_cache(torch.from_numpy(x[:, :0]))
    for i in range(3):
        step = x[:, i:i + 1]
        jo, jc = ja(paddle.to_tensor(step), paddle.to_tensor(step),
                    paddle.to_tensor(step), None, jc)
        to, tc = ta(*(torch.from_numpy(step),) * 3, None, tc)
        _near(to, jo)
        _near(tc.k, jc.k)
    jx = jnn.MultiHeadAttention.StaticCache
    js = ja.gen_cache(paddle.to_tensor(mem), type=jx)
    ts = ta.gen_cache(torch.from_numpy(mem),
                      type=tnn.MultiHeadAttention.StaticCache)
    _near(ts.v, js.v)
    jo, js2 = ja(paddle.to_tensor(x), None, None, None, js)
    to, ts2 = ta(torch.from_numpy(x), None, None, None, ts)
    assert ts2 is ts
    _near(to, jo)


def test_gen_cache_do_zip_and_encoder_cache():
    """do_zip regroups the per-layer pairs as JAX's; the encoder's
    incremental Cache path equals JAX's encoder run with caches."""
    jm, tm = _models()
    src, _, _ = _data(seed=4)
    memory = torch.from_numpy(src)
    zipped = tm.decoder.gen_cache(memory, do_zip=True)
    jzipped = jm.decoder.gen_cache(paddle.to_tensor(src), do_zip=True)
    assert len(zipped) == len(jzipped) == 2
    assert all(isinstance(c, tnn.MultiHeadAttention.Cache)
               for c in zipped[0])
    for got, want in zip(zipped[1], jzipped[1]):
        _near(got.k, want.k)
    tcache = tm.encoder.gen_cache(memory[:, :0])
    jcache = jm.encoder.gen_cache(paddle.to_tensor(src[:, :0]))
    for i in range(3):
        step = src[:, i:i + 1]
        to, tcache = tm.encoder(torch.from_numpy(step), None, tcache)
        jo, jcache = jm.encoder(paddle.to_tensor(step), None, jcache)
        _near(to, jo)
    assert tcache[0].k.shape[1] == 3


def test_converter_refuses_a_wrong_key():
    jm, tm = _models()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    state["decoder.layers.9.norm1.weight"] = np.ones(32, np.float32)
    with pytest.raises((KeyError, ValueError)):
        state_from_jax(state, tm, device="cpu")
