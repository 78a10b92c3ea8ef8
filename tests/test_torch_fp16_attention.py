"""float16 attention in the port (the plain twins of the flash and paged
kernels, ``sdpa_plain`` and ``nn.functional.scaled_dot_product_attention``,
run on CPU tensors) against the JAX package in float16: the Pallas flash
kernels in interpret mode and their ``jax.grad``, ``_sdpa_ref`` and
``_xla_paged_attention``, on numpy-seeded inputs.

Tolerances.  The Pallas kernels round P and dS to float16 before their
second products (``p.astype(v.dtype)``, ``ds.astype(k.dtype)``); the
port's twins keep them in f32, as the CUDA kernels' hi + lo terms do
to 2**-22.  Each such term moves by at most 2**-11 of itself and both
outputs round to float16 (2**-11): they agree to 2**-9 of the largest
value.  ``sdpa_plain`` and ``_sdpa_ref`` compute in f32 on both sides
and round once: one float16 step (2**-10 relative) plus 2**-12 of the
largest value for f32 summation order.  The paged twin and
``_xla_paged_attention`` likewise (one float16 step).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu.ops.pallas.flash import flash_attention as pallas_flash
from paddle_tpu.serving.paged_attention import _xla_paged_attention
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.flash_attention import flash_attention, flash_fwd
from paddle_tpu_torch.serving.paged_attention import (
    check_kernel_geometry, paged_attention,
)

from _torch_port_util import one_thread  # noqa: F401

F16 = "float16"
# (b, sq, sk, h, kh, d, causal)
CASES = {
    "mha_causal": (2, 64, 64, 4, 4, 16, True),
    "gqa_full": (1, 48, 48, 4, 2, 32, False),
    "short_q_causal": (1, 24, 80, 4, 2, 16, True),
}


def _inputs(shapes, seed):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _as16(*arrays):
    """numpy f32 -> (jax float16 arrays, torch float16 tensors), equal."""
    ts = [torch.from_numpy(a).to(torch.float16) for a in arrays]
    return [jnp.asarray(t.numpy()) for t in ts], ts


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _near(got, want, frac):
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


def _jax_grads(fn, q, k, v, do):
    loss = lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32)
                                   * do.astype(jnp.float32))
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _port_grads(fn, q, k, v, do):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    (out.float() * do.float()).sum().backward()
    return out.detach(), (q.grad, k.grad, v.grad)


def _qkv(case, seed):
    b, sq, sk, h, kh, d, causal = CASES[case]
    return _as16(*_inputs([(b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d),
                           (b, sq, h, d)], seed)), causal


@pytest.mark.parametrize("case", list(CASES))
def test_flash_fp16_matches_pallas_interpret(case):
    """Forward and gradients of the flash twins in float16 against the
    interpret-mode Pallas kernels and their jax.grad in float16."""
    ((jq, jk, jv, jdo), (q, k, v, do)), causal = _qkv(case, 0)
    pallas = lambda q, k, v: pallas_flash(q, k, v, causal=causal,
                                          interpret=True)
    out, grads = _port_grads(
        lambda q, k, v: flash_attention(q, k, v, causal=causal), q, k, v, do)
    assert out.dtype == torch.float16
    _near(out, pallas(jq, jk, jv).astype(jnp.float32), 2.0 ** -9)
    for got, want in zip(grads, _jax_grads(pallas, jq, jk, jv, jdo)):
        assert got.dtype == torch.float16
        _near(got, want.astype(jnp.float32), 2.0 ** -9)


def test_flash_fp16_fully_masked_rows_are_zero():
    """Causal with q_len > kv_len in float16: the rows that see no key
    output 0 with lse = -inf and get zero gradients, as _sdpa_ref's."""
    (jq, jk, jv, jdo), (q, k, v, do) = _as16(*_inputs(
        [(1, 8, 2, 16), (1, 4, 2, 16), (1, 4, 2, 16), (1, 8, 2, 16)], 1))
    ref = lambda q, k, v: _sdpa_ref(q, k, v, causal=True)
    out, lse = flash_fwd(q, k, v, 0.25, True)
    assert (out[:, :4] == 0).all() and torch.isneginf(lse[:, :, :4]).all()
    out, grads = _port_grads(
        lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, v, do)
    _near(out, ref(jq, jk, jv).astype(jnp.float32), 2.0 ** -9)
    for got, want in zip(grads, _jax_grads(ref, jq, jk, jv, jdo)):
        _near(got, want.astype(jnp.float32), 2.0 ** -9)
    assert (grads[0][:, :4] == 0).all()


def _masks(kind, b, h, sq, sk, r):
    if kind == "bool":
        m = r.rand(b, 1, sq, sk) > 0.3
        m[..., 0] = True
        return torch.from_numpy(m), jnp.asarray(m)
    if kind == "additive":
        m = (r.randn(b, h, sq, sk) * 2).astype(np.float32)
        return torch.from_numpy(m), jnp.asarray(m)
    return None, None


@pytest.mark.parametrize("kind", ["causal", "bool", "additive"])
def test_sdpa_plain_fp16_matches_sdpa_ref(kind):
    """sdpa_plain in float16 (f32 inside) against _sdpa_ref in float16:
    output and gradients, with the causal flag, a bool mask whose row
    sees at least key 0, and an additive mask."""
    b, sq, sk, h, d = 2, 12, 20, 2, 16
    r = np.random.RandomState(2)
    (jq, jk, jv, jdo), (q, k, v, do) = _as16(*_inputs(
        [(b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d)], 3))
    tm, jm = _masks(kind, b, h, sq, sk, r)
    causal = kind == "causal"
    ref = lambda q, k, v: _sdpa_ref(q, k, v, jm, causal=causal)
    out, grads = _port_grads(
        lambda q, k, v: F.sdpa_plain(q, k, v, tm, causal=causal), q, k, v,
        do)
    want = _f32(ref(jq, jk, jv).astype(jnp.float32))
    np.testing.assert_allclose(_f32(out), want, rtol=2.0 ** -10,
                               atol=2.0 ** -12 * np.abs(want).max())
    for got, w in zip(grads, _jax_grads(ref, jq, jk, jv, jdo)):
        w = _f32(w.astype(jnp.float32))
        np.testing.assert_allclose(_f32(got), w, rtol=2.0 ** -10,
                                   atol=2.0 ** -12 * np.abs(w).max())


def test_scaled_dot_product_attention_routes_fp16():
    """float16 with no mask and no dropout goes to the flash twin, with
    a mask to sdpa_plain; both in float16 like _sdpa_ref's."""
    (jq, jk, jv, _), (q, k, v, _) = _as16(*_inputs(
        [(1, 16, 2, 32)] * 4, 4))
    want = _f32(_sdpa_ref(jq, jk, jv).astype(jnp.float32))
    for mask in (None, torch.ones(1, 1, 16, 16, dtype=torch.bool)):
        got = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        assert got.dtype == torch.float16
        _near(got, want, 2.0 ** -9)


def _paged_case(s, qh, kh, seed, d=16, bs=4, nb=4, b=2):
    r = np.random.RandomState(seed)
    q = r.randn(b, s, qh, d).astype(np.float32)
    k = r.randn(1 + b * nb, bs, kh, d).astype(np.float32)
    v = r.randn(1 + b * nb, bs, kh, d).astype(np.float32)
    tables = (1 + r.permutation(b * nb)).astype(np.int32).reshape(b, nb)
    pos = np.array([9, 13 - s], np.int32)
    return q, k, v, tables, pos


@pytest.mark.parametrize("s,qh,kh", [(1, 4, 4), (4, 4, 2)])
def test_paged_fp16_matches_xla_reference(s, qh, kh):
    """The paged twin over a float16 pool, and over an int8 pool under a
    float16 query, against _xla_paged_attention in float16."""
    q, k, v, tables, pos = _paged_case(s, qh, kh, 5)
    (jq, jk, jv), (tq, tk, tv) = _as16(q, k, v)
    tt, tp = torch.from_numpy(tables), torch.from_numpy(pos)
    out = paged_attention(tq, tk, tv, tt, tp)
    assert out.dtype == torch.float16
    want = _f32(_xla_paged_attention(jq, jk, jv, jnp.asarray(tables),
                                     jnp.asarray(pos)).astype(jnp.float32))
    np.testing.assert_allclose(_f32(out), want, rtol=2.0 ** -10, atol=1e-6)
    r = np.random.RandomState(6)
    k8, v8 = (r.randint(-127, 128, k.shape).astype(np.int8)
              for _ in range(2))
    ks, vs = (r.rand(*k.shape[:2]).astype(np.float32) * 0.02 + 0.005
              for _ in range(2))
    out = paged_attention(tq, *(torch.from_numpy(a) for a in (k8, v8)), tt,
                          tp, torch.from_numpy(ks), torch.from_numpy(vs))
    want = _f32(_xla_paged_attention(
        jq, jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(tables),
        jnp.asarray(pos), jnp.asarray(ks), jnp.asarray(vs)).astype(
            jnp.float32))
    np.testing.assert_allclose(_f32(out), want, rtol=2.0 ** -10, atol=1e-6)


def test_kernel_geometry_takes_float16_and_refuses_float64():
    check_kernel_geometry(16, 32, 8, 128, torch.float16)
    with pytest.raises(TypeError, match="float16"):
        check_kernel_geometry(16, 32, 8, 128, torch.float64)
