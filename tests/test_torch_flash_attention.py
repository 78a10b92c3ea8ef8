"""The port's flash attention (the plain twins of its CUDA kernels, run
on CPU tensors, and the autograd.Function over them) against the JAX
Pallas flash kernels in interpret mode and their ``jax.grad``, on
numpy-seeded inputs: MHA and GQA, causal and not, a short query block
against a longer key block (the causal diagonal offset), and S = 200
(not a multiple of the Pallas block).

Tolerances.  f32: both sides compute in f32 and differ only in the order
of their sums (at these sizes one Pallas block covers every key), so
out, lse and the gradients agree to 2e-5 of their scale.  bf16: the
Pallas kernels round P and dS to bf16 before their second products
(``p.astype(v.dtype)``), the port keeps them in f32; each term then
moves by at most 2**-8 of itself, and the outputs, rounded to bf16 on
both sides, agree to 2**-6 of the largest value.

The SD UNet's head dims (40, 80, 160; not causal, cross-attention over
77 keys) are held against ``_sdpa_ref`` and its ``jax.grad`` (the JAX
package routes these short sequences to it on every backend but the
TPU), with the tolerances above.  The kernels run such a head dim at the
next instantiated one (40 at 48 in bf16), zero-padding their inputs and
slicing their outputs back: the same padding through the plain twins
gives the unpadded result (1e-6) with ``scale = 1/sqrt(true D)``, the
identity the kernel wrappers rest on (``chip_smoke.py`` holds the
wrappers themselves at D = 40 on the card).

The fully-masked case (causal, q_len > kv_len) is held against the JAX
package's ``_sdpa_ref``: zero output rows and zero gradients for the
rows that see no key, the flash-attn convention (the interpret-mode
Pallas kernel gives those rows mean(v) instead, a known reference
caveat).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu.ops.pallas.flash import _fa_fwd_padded
from paddle_tpu.ops.pallas.flash import flash_attention as pallas_flash
from paddle_tpu_torch.ops.flash_attention import (
    dkv_splits, flash_attention, flash_attention_plain, flash_bwd,
    flash_bwd_dkv_kernel, flash_bwd_dq_kernel, flash_bwd_plain, flash_fwd,
    flash_fwd_kernel, flash_fwd_plain, kernel_head_dim,
)

from _torch_port_util import one_thread  # noqa: F401

# (b, sq, sk, h, kh, d, causal)
CASES = {
    "mha_causal": (2, 64, 64, 4, 4, 16, True),
    "mha_full": (1, 64, 64, 4, 4, 16, False),
    "gqa_causal": (1, 48, 48, 8, 2, 16, True),
    "gqa_full": (2, 32, 32, 4, 2, 32, False),
    "short_q_causal": (1, 24, 80, 4, 2, 16, True),
    "short_q_full": (1, 24, 80, 4, 4, 16, False),
    "s200_causal": (1, 200, 200, 2, 1, 16, True),
}
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}


def _inputs(b, sq, sk, h, kh, d, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(b, sq, h, d).astype(np.float32)
    k = r.randn(b, sk, kh, d).astype(np.float32)
    v = r.randn(b, sk, kh, d).astype(np.float32)
    do = r.randn(b, sq, h, d).astype(np.float32)
    return q, k, v, do


def _as(dtype_name, *arrays):
    """numpy f32 -> (jax arrays, torch tensors) holding the same values
    in the dtype (bf16 rounds once, on the torch side)."""
    dt = getattr(torch, dtype_name)
    ts = [torch.from_numpy(a).to(dt) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype_name))
          for t in ts]
    return js, ts


def _close(out, ref, dtype_name):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL[dtype_name] * np.abs(ref).max())


def _jax_lse(q, k, v, scale, causal):
    """lse [B, H, Sq] of the interpret-mode Pallas forward."""
    b, sq, h, d = q.shape

    def bhsd(x):
        return x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], d)

    _, res = _fa_fwd_padded(bhsd(q), bhsd(k), bhsd(v), scale, causal, True)
    return np.asarray(res[4])[:, :sq, 0].reshape(b, h, sq)


def _jax_grads(fn, q, k, v, do):
    loss = lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32)
                                   * do.astype(jnp.float32))
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _port_grads(q, k, v, do, causal):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal)
    (out.float() * do.float()).sum().backward()
    return out.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_pallas_interpret(case, dtype_name):
    b, sq, sk, h, kh, d, causal = CASES[case]
    (jq, jk, jv, _), (q, k, v, _) = _as(dtype_name,
                                         *_inputs(b, sq, sk, h, kh, d))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_fwd(q, k, v, scale, causal)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, h, sq)
    ref = pallas_flash(jq, jk, jv, causal=causal, interpret=True)
    _close(out.float().numpy(), ref.astype(jnp.float32), dtype_name)
    ref_lse = _jax_lse(jq, jk, jv, scale, causal)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0,
                               atol=1e-2 if dtype_name == "bfloat16"
                               else 1e-5)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_pallas_interpret_grad(case, dtype_name):
    b, sq, sk, h, kh, d, causal = CASES[case]
    (jq, jk, jv, jdo), (q, k, v, do) = _as(
        dtype_name, *_inputs(b, sq, sk, h, kh, d, seed=1))
    ref = _jax_grads(lambda q, k, v: pallas_flash(q, k, v, causal=causal,
                                                  interpret=True),
                     jq, jk, jv, jdo)
    _, grads = _port_grads(q, k, v, do, causal)
    for got, want in zip(grads, ref):
        assert got.dtype == q.dtype
        _close(got.float().numpy(), want.astype(jnp.float32), dtype_name)


def test_fully_masked_rows_are_zero_with_zero_gradients():
    """q_len > kv_len under the causal mask: the first q_len - kv_len
    rows see no key.  Held against _sdpa_ref (output and jax.grad)."""
    q, k, v, do = _inputs(1, 8, 4, 2, 2, 16)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _as("float32", q, k, v, do)
    out, lse = flash_fwd(tq, tk, tv, 0.25, True)
    ref = _sdpa_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)
    assert (out[:, :4] == 0).all()
    assert torch.isneginf(lse[:, :, :4]).all()
    assert torch.isfinite(lse[:, :, 4:]).all()
    ref_g = _jax_grads(lambda q, k, v: _sdpa_ref(q, k, v, causal=True),
                       jq, jk, jv, jdo)
    _, grads = _port_grads(tq, tk, tv, tdo, True)
    for got, want in zip(grads, ref_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert (grads[0][:, :4] == 0).all()


def test_plain_forward_autograd_equals_the_recompute_backward():
    """flash_attention_plain (torch autograd through the dense forward)
    and flash_attention (the recompute backward twin) agree: the two
    references of the kernel path are one function."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(2, 40, 56, 4, 2, 16, seed=3))
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*ts, causal=True) * do).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_lse_is_the_log_sum_exp_of_the_scaled_scores():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 2, 8))
    _, lse = flash_fwd_plain(q, k, v, 0.5, False)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)


def test_cpu_tensors_run_the_plain_twins_uncounted():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 2, 8))
    counts = (flash_fwd_kernel.launches, flash_bwd_dq_kernel.launches,
              flash_bwd_dkv_kernel.launches)
    out, lse = flash_fwd(q, k, v, 0.3, True)
    flash_bwd(q, k, v, out, lse, do, 0.3, True)
    _port_grads(q, k, v, do, True)
    assert (flash_fwd_kernel.launches, flash_bwd_dq_kernel.launches,
            flash_bwd_dkv_kernel.launches) == counts


def test_other_devices_and_bad_inputs_raise():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), 0.3)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_bwd(*(t.to("meta") for t in (q, k, v, q)),
                  torch.zeros(1, 4, 8, device="meta"), do.to("meta"), 0.3)
    with pytest.raises(ValueError, match="divisible"):
        k3 = torch.cat([k, k[:, :, :1]], dim=2)          # 3 kv heads
        flash_attention(q, k3, k3)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_kernel(q, k, v, 0.3)


# the SD UNet's attention at a small size: (b, sq, sk, h, d)
UNET_CASES = {
    "d40_self": (2, 64, 64, 2, 40),
    "d40_cross": (2, 64, 77, 2, 40),
    "d80_cross": (1, 32, 77, 2, 80),
    "d160_self": (1, 16, 16, 2, 160),
    "d160_cross": (1, 16, 77, 2, 160),
}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_head_dims_match_sdpa_ref(case, dtype_name):
    b, sq, sk, h, d = UNET_CASES[case]
    (jq, jk, jv, jdo), (q, k, v, do) = _as(
        dtype_name, *_inputs(b, sq, sk, h, h, d, seed=4))
    ref = _sdpa_ref(jq, jk, jv)
    ref_g = _jax_grads(lambda q, k, v: _sdpa_ref(q, k, v), jq, jk, jv, jdo)
    out, grads = _port_grads(q, k, v, do, False)
    _close(out.float().numpy(), ref.astype(jnp.float32), dtype_name)
    for got, want in zip(grads, ref_g):
        assert got.shape[-1] == d
        _close(got.float().numpy(), want.astype(jnp.float32), dtype_name)


def test_kernel_head_dims():
    bf16, f32 = torch.bfloat16, torch.float32
    assert [kernel_head_dim(d, bf16) for d in (40, 48, 64, 80, 128, 160)] \
        == [48, 48, 64, 80, 128, 160]
    assert [kernel_head_dim(d, f32) for d in (40, 64, 80, 128)] \
        == [64, 64, 128, 128]
    for d, dt in ((161, bf16), (160, f32), (64, torch.float16)):
        with pytest.raises(ValueError, match="head_dim"):
            kernel_head_dim(d, dt)


@pytest.mark.parametrize("d,dp", [(40, 48), (40, 64), (80, 128)])
def test_pad_and_slice_keeps_the_true_scale(d, dp):
    """Zero-padding q, k, v (and out, dout) from d to dp columns and
    cutting the results back to d, at scale 1/sqrt(d), gives the unpadded
    out, lse, dq, dk and dv: zero columns add 0 to every score and to
    delta, and give zero output columns."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 40, 77, 2, 2, d,
                                                        seed=5))
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))
    scale = 1.0 / math.sqrt(d)
    ref, ref_lse = flash_fwd_plain(q, k, v, scale, False)
    out, lse = flash_fwd_plain(pad(q), pad(k), pad(v), scale, False)
    assert out.shape[-1] == dp and not out[..., d:].any()
    torch.testing.assert_close(out[..., :d], ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-6)
    want = flash_bwd_plain(q, k, v, ref, ref_lse, do, scale)
    got = flash_bwd_plain(pad(q), pad(k), pad(v), out, lse, pad(do), scale)
    for g, w in zip(got, want):
        assert g.shape[-1] == dp
        torch.testing.assert_close(g[..., :d], w, rtol=0, atol=1e-6)


def test_functional_sdpa_routes_to_flash_and_matches_sdpa_ref_with_masks_and_dropout(
        monkeypatch):
    """nn.functional.scaled_dot_product_attention with no mask and no
    training dropout routes every query length (here 16, under JAX's
    TPU threshold of 128) to flash attention, which matches _sdpa_ref;
    a bool or an additive mask (some rows with no visible key) runs the
    plain f32 path, which matches _sdpa_ref with the same mask to 2e-6 of
    its largest value (the same f32 terms, summed in another order), and
    so does training dropout with p = 0.1 on average: the mean of 48
    draws lies within 6 standard deviations of _sdpa_ref without
    dropout, elementwise."""
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.nn import functional as F

    calls = []
    flash = F.flash_attention
    monkeypatch.setattr(F, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    (jq, jk, jv), (q, k, v) = _as("float32", *_inputs(1, 16, 77, 2, 2, 40,
                                                      seed=6)[:3])
    out = F.scaled_dot_product_attention(q, k, v)
    _close(out.numpy(), _sdpa_ref(jq, jk, jv), "float32")
    F.scaled_dot_product_attention(q, k, v, dropout_p=0.1, training=False)
    assert len(calls) == 2
    r = np.random.RandomState(7)
    bool_mask = r.rand(1, 2, 16, 77) > 0.4
    bool_mask[0, 1, 3] = False                   # a row with no key
    add_mask = np.where(r.rand(1, 1, 1, 77) > 0.3, 0.0, -1e30).astype(
        np.float32) + r.randn(1, 1, 1, 77).astype(np.float32)
    for m in (bool_mask, add_mask):
        got = F.scaled_dot_product_attention(q, k, v,
                                             attn_mask=torch.from_numpy(m))
        want = np.asarray(_sdpa_ref(jq, jk, jv, jnp.asarray(m)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())
    assert len(calls) == 2
    assert not got.isnan().any()
    p, n = 0.1, 48
    prandom.seed(0)
    draws = torch.stack([F.scaled_dot_product_attention(q, k, v,
                                                        dropout_p=p)
                         for _ in range(n)])
    assert len(calls) == 2 and prandom.get_rng_state() == (0, n)
    probs = torch.softmax(torch.einsum("bshd,bthd->bhst", q, k)
                          / math.sqrt(40), -1)
    var = p / (1 - p) * torch.einsum("bhst,bthd->bshd", probs.square(),
                                     v.square())
    ref = torch.from_numpy(np.array(_sdpa_ref(jq, jk, jv)))
    assert ((draws.mean(0) - ref).abs() <= 6 * (var / n).sqrt() + 1e-6).all()


# (b, sq, sk, kh, d) -> the query split of the bf16 dK/dV kernel: the
# LM's train shapes (LLaMA-2-7B MHA and LLaMA-3-8B GQA, b=2, s=4096) and
# the SD UNet's (b=4, 8 heads) self- and cross-attention at 64x64 latents
SPLITS = {
    "llama2_7b_s4096": ((2, 4096, 4096, 32, 128), 1),
    "llama3_8b_gqa_s4096": ((2, 4096, 4096, 8, 128), 1),
    "llama2_7b_s2048": ((2, 2048, 2048, 32, 128), 1),
    "unet_level0_self": ((4, 4096, 4096, 8, 40), 1),
    "unet_level1_self": ((4, 1024, 1024, 8, 80), 1),
    "unet_level2_self": ((4, 256, 256, 8, 160), 1),   # 128 blocks
    "llama2_7b_q1024_k256": ((2, 1024, 256, 32, 128), 1),
    "unet_level0_cross": ((4, 4096, 77, 8, 40), 16),
    "unet_level1_cross": ((4, 1024, 77, 8, 80), 16),
    "unet_level2_cross": ((4, 256, 77, 8, 160), 4),
    "unet_mid_cross": ((4, 64, 77, 8, 160), 1),      # one query tile
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_dkv_splits_is_a_pure_function_of_the_shape(case):
    shape, want = SPLITS[case]
    b, sq, sk, kh, d = shape
    got = [dkv_splits(*shape) for _ in range(3)]
    assert got == [want] * 3
    assert 1 <= want <= max(1, -(-sq // 64))          # never past the tiles
    if want > 1:                   # a power of two that fills the card
        keys = 64 if d > 128 else 128
        blocks = -(-sk // keys) * kh * b
        assert 2 * blocks <= 132 and want & (want - 1) == 0
        assert blocks * want >= 2 * 132 or want == -(-sq // 64)


def _split_ranges(sq, ns):
    """The kernel's query ranges: NS contiguous runs of 64-row tiles,
    ceil(tiles / NS) each, the last ones possibly short or empty."""
    tiles = -(-sq // 64)
    per = -(-tiles // ns)
    return [(min(sq, 64 * min(tiles, s * per)),
             min(sq, 64 * min(tiles, (s + 1) * per))) for s in range(ns)]


@pytest.mark.parametrize("ns", [2, 4, 16])
@pytest.mark.parametrize("shape", [(2, 200, 77, 4, 2, 40),
                                   (1, 256, 77, 2, 2, 160),
                                   (2, 64, 33, 4, 4, 16)])
def test_split_partials_sum_to_the_unsplit_dkv(shape, ns):
    """dK and dV summed over NS contiguous query ranges, in index order
    and in f32 (the split kernel's partials and its summing kernel),
    equal the unsplit result within f32 rounding (cross-attention, not
    causal: the split's case)."""
    b, sq, sk, h, kh, d = shape
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(b, sq, sk, h, kh, d,
                                                        seed=8))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_fwd_plain(q, k, v, scale, False)
    _, dk, dv = flash_bwd_plain(q, k, v, out, lse, do, scale)
    sum_k, sum_v = torch.zeros_like(dk), torch.zeros_like(dv)
    for a, e in _split_ranges(sq, ns):
        if a == e:
            continue
        _, pk, pv = flash_bwd_plain(q[:, a:e], k, v, out[:, a:e],
                                    lse[:, :, a:e], do[:, a:e], scale)
        sum_k, sum_v = sum_k + pk, sum_v + pv
    for got, want in ((sum_k, dk), (sum_v, dv)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * want.abs().max().item())
