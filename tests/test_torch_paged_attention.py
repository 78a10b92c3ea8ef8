"""The port's paged attention (the plain PyTorch twin of its CUDA kernel)
against the JAX reference ``_xla_paged_attention`` and the Pallas kernel
``_pallas_paged_attention`` in interpret mode, on numpy-seeded inputs.

Tolerance: f32 inputs and f32 accumulation on both sides, the same
per-column recurrence, only the einsum summation order differs: 1e-5
absolute (outputs are O(1)).  bf16 outputs round the same f32 value:
one bf16 step (relative 2**-7)."""

import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.serving.paged_attention import (
    _pallas_paged_attention, _xla_paged_attention,
)
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving.paged_attention import (
    NEG_INF, paged_attention, paged_attention_kernel, paged_attention_plain,
)

from _torch_port_util import (  # noqa: F401
    TINY, TINY_GQA, jax_model, one_thread, port_model,
)

ATOL = 1e-5
LAYOUTS = pytest.mark.parametrize("qh,kh", [(4, 4), (4, 2)],
                                  ids=["mha", "gqa"])


def _case(b=2, s=1, qh=4, kh=2, d=8, bs=4, nb=4, seed=0, pos_vals=(9, 13)):
    r = np.random.RandomState(seed)
    q = r.randn(b, s, qh, d).astype(np.float32)
    num_blocks = 1 + b * nb
    k = r.randn(num_blocks, bs, kh, d).astype(np.float32)
    v = r.randn(num_blocks, bs, kh, d).astype(np.float32)
    tables = (1 + r.permutation(b * nb)).astype(np.int32).reshape(b, nb)
    pos = np.array(pos_vals, np.int32)[:b]
    return q, k, v, tables, pos


def _port(*arrays):
    return paged_attention(*(None if a is None else torch.from_numpy(a)
                             for a in arrays)).numpy()


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*(None if a is None else jnp.asarray(a)
                           for a in arrays), **kw))


@LAYOUTS
@pytest.mark.parametrize("s", [1, 4])
def test_matches_xla_reference(s, qh, kh):
    q, k, v, tables, pos = _case(s=s, qh=qh, kh=kh)
    base = pos - (s - 1)
    np.testing.assert_allclose(
        _port(q, k, v, tables, base),
        _jax(_xla_paged_attention, q, k, v, tables, base), rtol=0, atol=ATOL)


@LAYOUTS
@pytest.mark.parametrize("s", [1, 4])
def test_matches_pallas_kernel_interpret(s, qh, kh):
    q, k, v, tables, pos = _case(s=s, qh=qh, kh=kh, seed=1)
    base = pos - (s - 1)
    np.testing.assert_allclose(
        _port(q, k, v, tables, base),
        _jax(_pallas_paged_attention, q, k, v, tables, base,
             interpret=True), rtol=0, atol=ATOL)


@LAYOUTS
def test_pos_zero_lane_and_padding_lanes_on_scratch(qh, kh):
    """Lane 0 starts at pos 0 (sees only key 0 in row 0); lanes 2 and 3
    are padding: all-zero table rows that read scratch block 0."""
    q, k, v, tables, _ = _case(b=4, s=4, qh=qh, kh=kh, seed=2)
    tables[2:] = 0
    pos = np.array([0, 5, 0, 0], np.int32)
    out = _port(q, k, v, tables, pos)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(
        out, _jax(_xla_paged_attention, q, k, v, tables, pos),
        rtol=0, atol=ATOL)
    # row 0 of the pos-0 lane sees exactly key 0 of its first block
    g = qh // kh
    first = v[tables[0, 0], 0]                                  # [KH, D]
    np.testing.assert_allclose(out[0, 0], np.repeat(first, g, axis=0),
                               rtol=0, atol=1e-6)


@LAYOUTS
@pytest.mark.parametrize("s", [1, 4])
def test_nb_invariance_bitwise(s, qh, kh):
    """Appending all-zero (scratch) table columns changes nothing, bit
    for bit: the masking floor leaves m, l and acc untouched."""
    q, k, v, tables, pos = _case(s=s, qh=qh, kh=kh, seed=3)
    base = pos - (s - 1)
    wide = np.concatenate([tables, np.zeros((2, 4), np.int32)], axis=1)
    a = _port(q, k, v, tables, base)
    b = _port(q, k, v, wide, base)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("s", [1, 4])
def test_int8_pool_with_scales(s):
    q, kf, vf, tables, pos = _case(s=s, seed=4)
    r = np.random.RandomState(3)
    k = r.randint(-127, 128, kf.shape).astype(np.int8)
    v = r.randint(-127, 128, vf.shape).astype(np.int8)
    ks = r.uniform(0.01, 0.1, kf.shape[:2]).astype(np.float32)
    vs = r.uniform(0.01, 0.1, vf.shape[:2]).astype(np.float32)
    base = pos - (s - 1)
    out = _port(q, k, v, tables, base, ks, vs)
    np.testing.assert_allclose(
        out, _jax(_xla_paged_attention, q, k, v, tables, base, ks, vs),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        out, _jax(_pallas_paged_attention, q, k, v, tables, base, ks, vs,
                  interpret=True), rtol=0, atol=ATOL)


def test_bf16_matches_xla_reference_to_one_step():
    q, k, v, tables, pos = _case(s=2, seed=5)
    base = pos - 1
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = paged_attention(qb, kb, vb, torch.from_numpy(tables),
                          torch.from_numpy(base))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(_xla_paged_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (qb, kb, vb)),
        jnp.asarray(tables), jnp.asarray(base)).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0 ** -7,
                               atol=1e-6)


def test_cpu_tensors_run_the_plain_version_uncounted():
    q, k, v, tables, pos = (torch.from_numpy(a) for a in _case())
    before = paged_attention.launches
    out = paged_attention(q, k, v, tables, pos)
    assert paged_attention.launches == before
    assert torch.equal(out, paged_attention_plain(q, k, v, tables, pos))


def test_other_devices_raise():
    q, k, v, tables, pos = (torch.from_numpy(a).to("meta")
                            for a in _case())
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(q, k, v, tables, pos)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises before any
    build or launch."""
    q, k, v, tables, pos = (torch.from_numpy(a) for a in _case())
    with pytest.raises(ValueError, match="must be CUDA tensors"):
        paged_attention_kernel(q, k, v, tables, pos)


def test_masking_floor_matches_reference():
    assert NEG_INF == -1e30


@pytest.mark.parametrize("cfg", [TINY, TINY_GQA], ids=["mha", "gqa"])
def test_engine_prefill_geometry_matches_xla_reference(cfg, monkeypatch):
    """The call the port's engine makes for one batched prefill (three
    prompts padded to four lanes, the padding lane's table row all zero,
    one window at pos 0 padded to the length bucket), captured inside the
    first layer and run through the plain version and through JAX's
    ``_xla_paged_attention``: 1e-5 (f32 on both sides)."""
    gpt = importlib.import_module("paddle_tpu_torch.models.gpt")
    calls = []

    def capture(q, k_pool, v_pool, tables, pos, *rest):
        if not calls:         # the pools change in place: copy them now
            calls.append(tuple(t.clone() for t in (q, k_pool, v_pool,
                                                   tables, pos)))
        return paged_attention(q, k_pool, v_pool, tables, pos, *rest)

    monkeypatch.setattr(gpt, "paged_attention", capture)
    model = port_model(cfg, jax_model(cfg))
    eng = Engine(model, EngineConfig(num_slots=4, max_seq_len=64),
                 device="cpu")
    r = np.random.RandomState(6)
    for n in (17, 25, 30):                       # one length bucket: 32
        eng.submit(r.randint(0, cfg.vocab_size, n).tolist(),
                   SamplingParams(max_new_tokens=4))
    eng.admit()
    q, k, v, tables, pos = calls[0]
    assert tuple(q.shape[:2]) == (4, 32)         # 3 lanes padded to 4
    assert not pos.any() and not tables[3].any()
    assert (tables[:3] != 0).all()
    arrays = [t.numpy() for t in (q, k, v, tables, pos)]
    np.testing.assert_allclose(
        paged_attention_plain(q, k, v, tables, pos).numpy(),
        _jax(_xla_paged_attention, *arrays), rtol=0, atol=ATOL)


def _int8_tensor_core_model(q, k8, v8, ks, vs, tables, pos):
    """The arithmetic of the CUDA kernel's int8-pool path (the kInt8
    policy of ``csrc/attention_sm90.cuh``), in torch on the CPU: for each
    (lane, query head), fixed 64-key tiles from key 0; S = q . bf16(k) in
    f32 (int8 values are exact bf16 integers, q is bf16), times the K
    scale of each column; the online softmax in log2 units (scale
    log2 e / sqrt(D)); l takes p, then p is multiplied by the V scale
    and enters P V as its bf16 hi and lo terms over the unscaled V; out
    = O / l in bf16."""
    b, s, qh, d = q.shape
    bs, kh = k8.shape[1], k8.shape[2]
    g = qh // kh
    sl2 = math.log2(math.e) / math.sqrt(d)
    out = torch.empty(b, s, qh, d)
    last = torch.arange(s)[:, None]
    for lane in range(b):
        p0 = int(pos[lane])
        cols = tables[lane, :-(-(p0 + s) // bs)].long()
        keys = len(cols) * bs
        kk = k8[cols].to(torch.bfloat16).float().reshape(keys, kh, d)
        vv = v8[cols].to(torch.bfloat16).float().reshape(keys, kh, d)
        sk, sv = ks[cols].reshape(keys), vs[cols].reshape(keys)
        for h in range(qh):
            qv = q[lane, :, h].float()
            m = torch.full((s,), NEG_INF)
            l = torch.zeros(s)
            o = torch.zeros(s, d)
            for t0 in range(0, keys, 64):
                t = slice(t0, min(keys, t0 + 64))
                key = torch.arange(t.start, t.stop)[None, :]
                vis = key <= p0 + last
                sc = (qv @ kk[t, h // g].T) * sk[t]
                mr = torch.where(vis, sc, -math.inf).amax(1)
                mn = torch.where(mr == -math.inf, m,
                                 torch.maximum(m, mr * sl2))
                alpha = torch.exp2(m - mn)
                p = torch.where(vis, torch.exp2(sc * sl2 - mn[:, None]), 0.0)
                l = l * alpha + p.sum(1)
                p = p * sv[t]
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                vt = vv[t, h // g]
                o = o * alpha[:, None] + hi @ vt + lo @ vt
                m = mn
            out[lane, :, h] = o / l[:, None]
    return out.to(torch.bfloat16)


@LAYOUTS
@pytest.mark.parametrize("s", [1, 5, 64])
def test_int8_tensor_core_formulation_matches_xla_reference(s, qh, kh):
    """The CUDA kernel's int8 formulation (int8 K/V converted exactly to
    bf16, the K scale on S's columns, the V scale on p after l and
    before the hi/lo split) against ``_xla_paged_attention`` (blocks
    dequantized token-wise before the math), at the card's bf16
    tolerance (chip_smoke.py ``TOLERANCES["bfloat16"]``: 2**-7 of each
    value plus 1e-3 of the largest): it holds the fold before the kernel
    runs on the card."""
    d, bs, b = 16, 16, 2
    r = np.random.RandomState(20 + s)
    pos = np.array([70, 3], np.int32)
    nb = -(-(int(pos.max()) + s) // bs)
    num_blocks = 1 + b * nb
    tables = (1 + r.permutation(b * nb)).astype(np.int32).reshape(b, nb)
    q = torch.from_numpy(r.randn(b, s, qh, d).astype(np.float32)).to(
        torch.bfloat16)
    k = r.randint(-127, 128, (num_blocks, bs, kh, d)).astype(np.int8)
    v = r.randint(-127, 128, (num_blocks, bs, kh, d)).astype(np.int8)
    ks = r.uniform(0.005, 0.025, (num_blocks, bs)).astype(np.float32)
    vs = r.uniform(0.005, 0.025, (num_blocks, bs)).astype(np.float32)
    got = _int8_tensor_core_model(q, *(torch.from_numpy(a) for a in (
        k, v, ks, vs, tables, pos))).float().numpy()
    ref = _jax(_xla_paged_attention, q.float().numpy(), k, v, tables, pos,
               ks, vs)
    np.testing.assert_array_less(
        np.abs(got - ref), 2.0 ** -7 * np.abs(ref) + 1e-3 * np.abs(ref).max()
        + 1e-12)
