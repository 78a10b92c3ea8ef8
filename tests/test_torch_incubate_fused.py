"""The port's fused generation functionals
(``paddle_tpu_torch.incubate.nn.functional``, ``ops.rope``,
``ops.rms_norm.rms_norm_arrays``, ``ops.softmax_mask_fuse``) against
``paddle_tpu.incubate.nn.functional`` and the JAX ops on the same
numpy-seeded inputs, on the CPU: 2 layers, dim 64, 4 heads of 16, FFN
128, ``max_seq`` 16.

Tolerance: f32 on both sides, the same terms summed in another order
(and the LayerNorm twin's two-pass f32 statistics against jnp's): 2e-5
of the largest value of the reference, through two layers and their
caches (measured ~3e-7).  bf16: the port's layer norms keep f32
statistics (the LayerNorm kernel's twin) where JAX's jnp norm rounds the
mean, the variance and ``rsqrt`` to bf16, so the outputs part by a few
bf16 steps: 2**-5 of the largest value (8 steps of 2**-8).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.ops.rms_norm as jrms
from paddle_tpu.incubate import (softmax_mask_fuse as j_smf,
                                 softmax_mask_fuse_upper_triangle as j_smfu)
from paddle_tpu.ops.rope import apply_rotary_emb as j_rope

from paddle_tpu_torch.convert import (FUSED_MT_WEIGHTS,
                                      fused_multi_transformer_params_from_jax)
from paddle_tpu_torch.incubate import (softmax_mask_fuse as t_smf,
                                       softmax_mask_fuse_upper_triangle as
                                       t_smfu)
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops.rms_norm import rms_norm_arrays
from paddle_tpu_torch.ops.rope import apply_rotary_emb as t_rope

from _torch_port_util import one_thread  # noqa: F401

L, DIM, HEADS, FFN, MAX_SEQ = 2, 64, 4, 128, 16
HD = DIM // HEADS
F32_FRAC, BF16_FRAC = 2e-5, 2.0 ** -5


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t.numpy(), np.float32)


def _near(got, want, frac=F32_FRAC):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


def _j(a):
    return paddle.to_tensor(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(seed, trans_qkvw=True):
    r = np.random.RandomState(seed)
    mk = lambda *sh: (r.randn(*sh) * 0.05).astype(np.float32)  # noqa: E731
    qkv = (3, HEADS, HD, DIM) if trans_qkvw else (DIM, 3, HEADS, HD)
    shapes = dict(ln_scales=(DIM,), ln_biases=(DIM,), qkv_weights=qkv,
                  qkv_biases=(3 * DIM,), linear_weights=(DIM, DIM),
                  linear_biases=(DIM,), ffn_ln_scales=(DIM,),
                  ffn_ln_biases=(DIM,), ffn1_weights=(DIM, FFN),
                  ffn1_biases=(FFN,), ffn2_weights=(FFN, DIM),
                  ffn2_biases=(DIM,))
    p = {k: [mk(*shapes[k]) + (1.0 if k.endswith("scales") else 0.0)
             for _ in range(L)] for k in FUSED_MT_WEIGHTS}
    return p


def _jparams(p):
    return {k: [_j(a) for a in v] for k, v in p.items()}


def _rope_tables(b, hd, neox):
    """Packed full-head-dim [2, b, 1, MAX_SEQ, hd] cos/sin."""
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2, np.float64) / hd))
    fr = np.outer(np.arange(MAX_SEQ, dtype=np.float64), inv)
    if neox:
        cos = np.concatenate([np.cos(fr)] * 2, -1)
        sin = np.concatenate([np.sin(fr)] * 2, -1)
    else:
        cos, sin = np.repeat(np.cos(fr), 2, -1), np.repeat(np.sin(fr), 2, -1)
    t = np.stack([cos, sin]).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(t[:, None, None],
                                                (2, b, 1, MAX_SEQ, hd)))


def _causal_mask(b, s, seed):
    """An additive [b, 1, s, s] mask hiding a few keys of row 1."""
    m = np.zeros((b, 1, s, s), np.float32)
    m[1, ..., :2] = -1e4
    m += np.random.RandomState(seed).randn(b, 1, s, s).astype(np.float32)
    return m


# name: (pre_layer_norm, activation, trans_qkvw, rotary (None, "neox",
# "gptj"), masked, caches)
FMT_CASES = {
    "pre_gelu_flash": (True, "gelu", True, None, False, True),
    "post_relu_untransposed_neox": (False, "relu", False, "neox", False,
                                    True),
    "pre_silu_gptj_masked": (True, "silu", True, "gptj", True, True),
}


@pytest.mark.parametrize("case", list(FMT_CASES))
def test_fused_multi_transformer_matches_jax(case):
    """Prefill (s 6 of b 2), then two decode steps where the case keeps
    caches: outputs and every cache against JAX's."""
    pre, act, trans, rot, masked, caches = FMT_CASES[case]
    p = _params(1, trans)
    jp, tp = _jparams(p), fused_multi_transformer_params_from_jax(
        p, device="cpu")
    r = np.random.RandomState(2)
    b, s = 2, 6
    x = (r.randn(b, s, DIM) * 0.3).astype(np.float32)
    kw = dict(pre_layer_norm=pre, activation=act, trans_qkvw=trans)
    jkw, tkw = dict(kw), dict(kw)
    if rot:
        tab = _rope_tables(b, HD, rot == "neox")
        for d, conv in ((jkw, _j), (tkw, _t)):
            d.update(rotary_embs=conv(tab), rotary_emb_dims=1,
                     use_neox_rotary_style=rot == "neox")
    if masked:
        m = _causal_mask(b, s, 3)
        jkw["attn_mask"], tkw["attn_mask"] = _j(m), _t(m)
    if not caches:
        want = JIF.fused_multi_transformer(_j(x), **jp, **jkw)
        got = TIF.fused_multi_transformer(_t(x), **tp, **tkw)
        _near(got, want)
        return
    zeros = np.zeros((2, b, HEADS, MAX_SEQ, HD), np.float32)
    jc = [_j(zeros) for _ in range(L)]
    tc = [_t(zeros.copy()) for _ in range(L)]
    want, jc = JIF.fused_multi_transformer(_j(x), cache_kvs=jc, **jp, **jkw)
    got, tc2 = TIF.fused_multi_transformer(_t(x), cache_kvs=tc, **tp, **tkw)
    assert all(a is c for a, c in zip(tc2, tc))       # written in place
    _near(got, want)
    for a, c in zip(tc, jc):
        _near(a, c)
    for step in range(2):
        t = s + step
        xs = (r.randn(b, 1, DIM) * 0.3).astype(np.float32)
        jd, td = dict(jkw), dict(tkw)
        if masked:                      # the decode mask covers [0, t]
            m = np.zeros((b, 1, 1, t + 1), np.float32)
            m[1, ..., :2] = -1e4
            jd["attn_mask"], td["attn_mask"] = _j(m), _t(m)
        want, jc = JIF.fused_multi_transformer(
            _j(xs), cache_kvs=jc, time_step=_j(np.asarray(t, np.int32)),
            **jp, **jd)
        got, tc = TIF.fused_multi_transformer(
            _t(xs), cache_kvs=tc, time_step=torch.tensor(t), **tp, **td)
        _near(got, want)
        for a, c in zip(tc, jc):
            _near(a, c)


def test_fused_multi_transformer_bf16_matches_jax():
    """A bf16 prefill without caches (the flash twin, the LayerNorm twin)
    against JAX's bf16, within the stated bf16 bound."""
    p = _params(4)
    x = (np.random.RandomState(5).randn(2, 5, DIM) * 0.3).astype(np.float32)
    jp = {k: [_j(a).astype("bfloat16") for a in v] for k, v in p.items()}
    tp = fused_multi_transformer_params_from_jax(p, device="cpu",
                                                 dtype=torch.bfloat16)
    want = JIF.fused_multi_transformer(_j(x).astype("bfloat16"), **jp)
    got = TIF.fused_multi_transformer(_t(x).to(torch.bfloat16), **tp)
    assert got.dtype == torch.bfloat16
    _near(got, want, BF16_FRAC)


def test_fused_multi_transformer_backward_through_the_kernels(monkeypatch):
    """Gradients of a weighted sum of a prefill with respect to x and
    every weight through the flash and LayerNorm autograd functions (the
    kernels' backward on the card, their plain twins here) against
    torch autograd over the plain forwards (``flash_attention_plain``,
    ``layer_norm_plain``): the same f32 function, 2e-5 of the largest
    gradient."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    from paddle_tpu_torch.ops.layer_norm import layer_norm_plain

    p = _params(4)
    r = np.random.RandomState(5)
    x = (r.randn(2, 5, DIM) * 0.3).astype(np.float32)
    g = _t(r.randn(2, 5, DIM).astype(np.float32))

    def grads():
        tp = fused_multi_transformer_params_from_jax(p, device="cpu")
        leaves = [t.requires_grad_() for v in tp.values() for t in v]
        tx = _t(x).requires_grad_()
        (TIF.fused_multi_transformer(tx, **tp) * g).sum().backward()
        return [tx.grad] + [t.grad for t in leaves]

    got = grads()
    monkeypatch.setattr(TIF, "_flash_op", flash_attention_plain)
    monkeypatch.setattr(TIF, "_layer_norm_op", layer_norm_plain)
    for a, b in zip(got, grads()):
        _near(a, b)


RAISES = ["pre_caches", "rotary_dims", "full_cache", "short_rotary"]


@pytest.mark.parametrize("case", RAISES)
def test_fused_multi_transformer_raises_as_jax(case):
    p = _params(6)
    x = np.zeros((1, 4, DIM), np.float32)
    caches = np.zeros((2, 1, HEADS, MAX_SEQ, HD), np.float32)
    tab = _rope_tables(1, HD, True)[:, :, :, :2]      # 2 positions < 4
    kw = {"pre_caches": dict(pre_caches=[caches] * L),
          "rotary_dims": dict(rotary_emb_dims=2),
          "full_cache": dict(cache_kvs=[caches] * L, time_step=MAX_SEQ),
          "short_rotary": dict(rotary_embs=tab, rotary_emb_dims=1)}[case]
    err = NotImplementedError if case in RAISES[:2] else ValueError
    conv = {"j": _j, "t": lambda a: _t(np.array(a))}
    for side, fn, params in (
            ("j", JIF.fused_multi_transformer, _jparams(p)),
            ("t", TIF.fused_multi_transformer,
             fused_multi_transformer_params_from_jax(p, device="cpu"))):
        c = conv[side]
        args = {k: ([c(a) for a in v] if isinstance(v, list) else
                    c(np.asarray(v, np.int32)) if k == "time_step" else
                    c(v) if isinstance(v, np.ndarray) else v)
                for k, v in kw.items()}
        with pytest.raises(err):
            fn(c(x), **params, **args)


# name: (src_mask, rotary (None, "neox", "gptj"))
MMHA_CASES = {"lengths": (False, None), "rotary_neox_mask": (True, "neox"),
              "rotary_gptj": (False, "gptj")}


@pytest.mark.parametrize("case", list(MMHA_CASES))
def test_masked_multihead_attention_matches_jax(case):
    """One decode step of b 3 at ragged cached lengths (0, 5, 11) over
    a [2, 3, 4, 16, 16] cache: output and the cache (written in place)
    against JAX's."""
    masked, rot = MMHA_CASES[case]
    r = np.random.RandomState(7)
    b = 3
    lens = np.array([0, 5, 11], np.int32)
    cache = np.zeros((2, b, HEADS, MAX_SEQ, HD), np.float32)
    for i, n in enumerate(lens):
        cache[:, i, :, :n] = r.randn(2, HEADS, n, HD)
    x = r.randn(b, 3 * HEADS * HD).astype(np.float32)
    jkw, tkw = {}, {}
    if masked:
        m = np.zeros((b, 1, 1, 12), np.float32)     # covers [0, step + 1)
        m[2, ..., 3:6] = -1e4
        m[1] += r.randn(1, 1, 12).astype(np.float32)
        jkw["src_mask"], tkw["src_mask"] = _j(m), _t(m)
    if rot:
        tab = _rope_tables(b, HD, rot == "neox")
        for d, conv in ((jkw, _j), (tkw, _t)):
            d.update(rotary_tensor=conv(tab), rotary_emb_dims=1,
                     use_neox_rotary_style=rot == "neox")
    want, jcache = JIF.masked_multihead_attention(
        _j(x), cache_kv=_j(cache), sequence_lengths=_j(lens), **jkw)
    tcache = _t(cache.copy())
    got, tc = TIF.masked_multihead_attention(
        _t(x), cache_kv=tcache, sequence_lengths=_t(lens), **tkw)
    assert tc is tcache
    _near(got, want)
    _near(tc, jcache)


@pytest.mark.parametrize("case", ["full", "bias", "rotary_dims"])
def test_masked_multihead_attention_raises_as_jax(case):
    cache = np.zeros((2, 2, HEADS, MAX_SEQ, HD), np.float32)
    x = np.zeros((2, 3 * HEADS * HD), np.float32)
    lens = np.array([3, MAX_SEQ if case == "full" else 4], np.int32)
    kw = {"full": {}, "bias": dict(bias=np.zeros(3 * DIM, np.float32)),
          "rotary_dims": dict(rotary_emb_dims=2)}[case]
    err = ValueError if case == "full" else NotImplementedError
    for fn, c in ((JIF.masked_multihead_attention, _j),
                  (TIF.masked_multihead_attention, lambda a: _t(a.copy()))):
        with pytest.raises(err):
            fn(c(x), cache_kv=c(cache), sequence_lengths=c(lens),
               **{k: c(v) if isinstance(v, np.ndarray) else v
                  for k, v in kw.items()})


def _norm_inputs(seed, shape):
    r = np.random.RandomState(seed)
    f = lambda *sh: r.randn(*sh).astype(np.float32)  # noqa: E731
    return (f(*shape), f(shape[-1]) * 0.1 + 1, f(shape[-1]) * 0.1,
            f(shape[-1]) * 0.1, f(*shape))


# name: (function, shape, kwargs)
NORM_CASES = {
    "layer_norm_3d_default_axis": ("layer", (2, 5, DIM), {}),
    "layer_norm_2d_residual_bias": ("layer", (10, DIM),
                                    dict(bias=1, residual=1,
                                         residual_alpha=0.5)),
    "layer_norm_3d_last_axis": ("layer", (2, 5, DIM),
                                dict(begin_norm_axis=2, residual=1)),
    "rms_norm_3d_default_axis": ("rms", (2, 5, DIM), {}),
    "rms_norm_2d_kernel_route": ("rms", (10, DIM), dict(residual=1,
                                                        bias=1)),
    "rms_norm_3d_last_axis_norm_bias": ("rms", (2, 5, DIM),
                                        dict(begin_norm_axis=-1,
                                             norm_bias=1)),
}


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_fused_norms_match_jax(case):
    """``fused_layer_norm`` / ``fused_rms_norm`` with ``residual`` and
    ``bias``, at the default ``begin_norm_axis=1`` (3-D: the last two
    axes, the plain path) and over the last axis (the kernels' route,
    their plain twins here)."""
    kind, shape, kw = NORM_CASES[case]
    x, w, bvec, nb, res = _norm_inputs(8, shape)
    extra = {"bias": bvec, "residual": res, "norm_bias": nb}
    jkw = {k: (_j(extra[k]) if v == 1 else v) for k, v in kw.items()}
    tkw = {k: (_t(extra[k]) if v == 1 else v) for k, v in kw.items()}
    if kind == "layer":
        want = JIF.fused_layer_norm(_j(x), _j(w), _j(bvec), **jkw)
        got = TIF.fused_layer_norm(_t(x), _t(w), _t(bvec), **tkw)
    else:
        want = JIF.fused_rms_norm(_j(x), _j(w), **jkw)
        got = TIF.fused_rms_norm(_t(x), _t(w), **tkw)
    _near(got, want)


def test_rms_norm_arrays_matches_jax():
    """``ops.rms_norm.rms_norm_arrays``: weight and bias, no weight, and
    bf16 on the kernel's route (its twin rounds ``x * rstd * w`` once,
    JAX ``x * rstd`` first: one bf16 step apart at most, 2**-7)."""
    x, w, bvec, _, _ = _norm_inputs(9, (3, 4, DIM))
    for kw in (dict(weight=w, bias=bvec), dict(begin_norm_axis=1), {}):
        want = jrms.rms_norm(_j(x), **{k: _j(v) if isinstance(
            v, np.ndarray) else v for k, v in kw.items()})
        got = rms_norm_arrays(_t(x), **{k: _t(v) if isinstance(
            v, np.ndarray) else v for k, v in kw.items()})
        _near(got, want)
    want = jrms.rms_norm(_j(x).astype("bfloat16"), _j(w).astype("bfloat16"))
    got = rms_norm_arrays(_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16))
    _near(got, want, 2.0 ** -7)


def _rope_inputs():
    r = np.random.RandomState(10)
    x = r.randn(2, 5, 3, 16).astype(np.float32)
    ang = r.rand(5, 8).astype(np.float32) * 3
    return x, ang


# name: (sin/cos form, neox, position_ids)
ROPE_CASES = {
    "positions_neox": (None, True, True),
    "default_positions_gptj": (None, False, False),
    "half_table_neox": ("half", True, False),
    "batch_half_table_gptj": ("batch", False, False),
    "paddle_1s1d_neox": ("paddle", True, False),
    "full_table_gptj": ("full", False, False),
}


@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope_matches_jax(case):
    """``ops.rope.apply_rotary_emb`` over JAX's table forms ([S, D/2],
    [B, S, D/2], [1, S, 1, D], [S, D]) and positions, NeoX and GPT-J
    pairs, and ``fused_rotary_position_embedding`` over q, k (v None)."""
    form, neox, pos = ROPE_CASES[case]
    x, ang = _rope_inputs()
    kw = {"neox": neox}
    if pos:
        kw["position_ids"] = np.array([[0, 1, 2, 3, 4], [3, 4, 5, 6, 7]],
                                      np.int64)
    if form:
        sin, cos = np.sin(ang), np.cos(ang)
        if form == "batch":
            sin, cos = np.stack([sin, sin * 0.5]), np.stack([cos, cos * 0.5])
        elif form in ("paddle", "full"):
            sin = np.concatenate([sin, sin], -1)
            cos = np.concatenate([cos, cos], -1)
            if form == "paddle":
                sin, cos = sin[None, :, None], cos[None, :, None]
        kw.update(sin=sin, cos=cos)
    jkw = {k: _j(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    _near(t_rope(_t(x), **tkw), j_rope(_j(x), **jkw))
    ren = {"neox": "use_neox_rotary_style"}
    jq, jk, jv = JIF.fused_rotary_position_embedding(
        _j(x), _j(x * 2), **{ren.get(k, k): v for k, v in jkw.items()})
    tq, tk, tv = TIF.fused_rotary_position_embedding(
        _t(x), _t(x * 2), **{ren.get(k, k): v for k, v in tkw.items()})
    assert jv is None and tv is None
    _near(tq, jq)
    _near(tk, jk)


@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_swiglu_and_fused_ec_moe_match_jax(act):
    """``swiglu`` (split and two-input) and ``fused_ec_moe`` over 3
    experts (its gelu is ``jax.nn.gelu``'s tanh form); a bad act_type
    raises in both."""
    r = np.random.RandomState(11)
    x = r.randn(2, 3, 8).astype(np.float32)
    y = r.randn(2, 3, 8).astype(np.float32)
    _near(TIF.swiglu(_t(x)), JIF.swiglu(_j(x)))
    _near(TIF.swiglu(_t(x), _t(y)), JIF.swiglu(_j(x), _j(y)))
    gate = r.randn(2, 3, 3).astype(np.float32)
    w0, b0 = r.randn(3, 8, 12).astype(np.float32), r.randn(3, 1, 12).astype(
        np.float32)
    w1, b1 = r.randn(3, 12, 8).astype(np.float32), r.randn(3, 1, 8).astype(
        np.float32)
    args = (x, gate, w0, b0, w1, b1)
    _near(TIF.fused_ec_moe(*map(_t, args), act_type=act),
          JIF.fused_ec_moe(*map(_j, args), act_type=act))
    for fn, c in ((JIF.fused_ec_moe, _j), (TIF.fused_ec_moe, _t)):
        with pytest.raises(ValueError):
            fn(*map(c, args), act_type="tanh")


# name: (pre_layer_norm, transpose_qkv_wb, mask)
MHA_CASES = {"post_packed": (False, False, False),
             "pre_transposed": (True, True, False),
             "post_transposed_mask": (False, True, True),
             "pre_packed_mask": (True, False, True)}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_fused_multi_head_attention_matches_jax(case):
    """In eval (``training=False``): no mask runs flash (the twin here),
    a mask the plain f32 path, in both packings of the qkv weight."""
    pre, transposed, masked = MHA_CASES[case]
    r = np.random.RandomState(12)
    f = lambda *sh: (r.randn(*sh) * 0.1).astype(np.float32)  # noqa: E731
    x = f(2, 6, DIM) * 3
    qkvw = f(DIM, 3 * DIM) if transposed else f(3, HEADS, HD, DIM)
    arrs = dict(qkv_weight=qkvw, linear_weight=f(DIM, DIM),
                pre_ln_scale=f(DIM) + 1, pre_ln_bias=f(DIM),
                ln_scale=f(DIM) + 1, ln_bias=f(DIM), qkv_bias=f(3 * DIM),
                linear_bias=f(DIM))
    if masked:
        m = np.zeros((2, 1, 6, 6), np.float32)
        m[1, ..., 4:] = -1e9
        arrs["attn_mask"] = m
    kw = dict(pre_layer_norm=pre, training=False, num_heads=HEADS,
              transpose_qkv_wb=transposed)
    want = JIF.fused_multi_head_attention(
        _j(x), **{k: _j(v) for k, v in arrs.items()}, **kw)
    got = TIF.fused_multi_head_attention(
        _t(x), **{k: _t(v) for k, v in arrs.items()}, **kw)
    _near(got, want)


@pytest.mark.parametrize("pre,act", [(False, "relu"), (True, "gelu")],
                         ids=["post_relu", "pre_gelu"])
def test_fused_feedforward_matches_jax(pre, act):
    r = np.random.RandomState(13)
    f = lambda *sh: (r.randn(*sh) * 0.1).astype(np.float32)  # noqa: E731
    arrs = (f(2, 6, DIM) * 3, f(DIM, FFN), f(FFN, DIM), f(FFN), f(DIM),
            f(DIM) + 1, f(DIM), f(DIM) + 1, f(DIM))
    kw = dict(activation=act, pre_layer_norm=pre, training=False)
    _near(TIF.fused_feedforward(*map(_t, arrs), **kw),
          JIF.fused_feedforward(*map(_j, arrs), **kw))


def test_linear_helpers_match_jax():
    """``fused_linear`` (both weight layouts), ``fused_matmul_bias``,
    ``fused_linear_activation``, ``fused_bias_act``,
    ``fused_dropout_add`` (out of training: x + y) and
    ``fused_linear_cross_entropy`` (an ignored label among them)."""
    r = np.random.RandomState(14)
    f = lambda *sh: r.randn(*sh).astype(np.float32)  # noqa: E731
    x, w, b = f(3, 4, 8), f(8, 6), f(6)
    _near(TIF.fused_linear(_t(x), _t(w), _t(b)),
          JIF.fused_linear(_j(x), _j(w), _j(b)))
    _near(TIF.fused_linear(_t(x), _t(w.T.copy()), transpose_weight=True),
          JIF.fused_linear(_j(x), _j(w.T.copy()), transpose_weight=True))
    a, c = f(5, 8), f(6, 8)
    for kw in (dict(transpose_y=True), {}):
        y = c if kw else c.T.copy()
        _near(TIF.fused_matmul_bias(_t(a), _t(y), _t(b), **kw),
              JIF.fused_matmul_bias(_j(a), _j(y), _j(b), **kw))
    _near(TIF.fused_linear_activation(_t(a.T.copy()), _t(c), _t(b), True,
                                      True, "relu"),
          JIF.fused_linear_activation(_j(a.T.copy()), _j(c), _j(b), True,
                                      True, "relu"))
    bias = f(8)
    _near(TIF.fused_bias_act(_t(x), _t(bias)),
          JIF.fused_bias_act(_j(x), _j(bias)))
    y = f(3, 4, 8)
    _near(TIF.fused_dropout_add(_t(x), _t(y), p=0.3, training=False),
          JIF.fused_dropout_add(_j(x), _j(y), p=0.3, training=False))
    h, wv = f(7, 8), f(8, 11)
    lab = np.array([1, 4, -100, 10, 0, 3, 3], np.int64)
    _near(TIF.fused_linear_cross_entropy(_t(h), _t(wv), _t(lab),
                                         chunk_rows=3),
          JIF.fused_linear_cross_entropy(_j(h), _j(wv), _j(lab),
                                         chunk_rows=3))


def test_softmax_mask_fuse_matches_jax():
    r = np.random.RandomState(15)
    x = r.randn(2, 3, 4, 6).astype(np.float32)
    m = np.where(r.rand(2, 1, 4, 6) > 0.3, 0.0, -1e4).astype(np.float32)
    _near(t_smf(_t(x), _t(m)), j_smf(_j(x), _j(m)))
    _near(t_smfu(_t(x)), j_smfu(_j(x)))
