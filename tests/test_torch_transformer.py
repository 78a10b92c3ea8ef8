"""The port's Transformer encoder and the functionals under it against
the JAX package's, in f32 on the CPU, on numpy-seeded inputs and the JAX
layers' own weights (Linear weights transposed to the port's
``[out, in]``): ``MultiHeadAttention`` (the fused q/k/v product against
separate projections), ``TransformerEncoderLayer`` with both
``normalize_before`` settings, with no mask, a bool mask (a row with no
visible key among them) and an additive mask, outputs and every
gradient; ``nn.functional.cross_entropy`` over its options (integer and
soft labels, ``ignore_index``, ``weight``, ``label_smoothing``, ``axis``,
the three reductions, bf16 logits); ``gelu`` exact and approximate,
``embedding`` with ``padding_idx`` and ``linear``.

Tolerances: the same f32 arithmetic in another summation order: outputs
and gradients to 1e-5 of their largest magnitude (a gradient that is 0
in exact arithmetic, the key bias's, to 1e-6 of the layer's largest);
f32 losses to 1e-6 relative.  bf16 logits: JAX's ``log_softmax`` and
the port's both run in bf16 and round once each (the port's computes in
f32 inside), the loss to 2**-7 relative plus 2**-8 absolute (a bf16
step of a value near 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import (
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer,
)
from paddle_tpu_torch.nn import functional as F

from _torch_port_util import one_thread  # noqa: F401

B, S, E, H = 2, 9, 16, 4


def _load(tm, jm):
    """The JAX layer's weights into the port's, 2-D ones transposed."""
    sd = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v.numpy())
        sd[k] = torch.from_numpy((a.T if a.ndim == 2 else a).copy())
    tm.load_state_dict(sd)


def _masks(kind, seed):
    r = np.random.RandomState(seed)
    if kind is None:
        return None, None
    if kind == "bool":
        m = r.rand(B, 1, S, S) > 0.3
        m[0, 0, 2] = False                       # a row with no key
        return paddle.to_tensor(m), torch.from_numpy(m)
    m = np.where(r.rand(B, 1, 1, S) > 0.25, 0.0, -1e30).astype(np.float32)
    m += r.randn(B, 1, 1, S).astype(np.float32) * 0.5
    return paddle.to_tensor(m), torch.from_numpy(m)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _run_both(jlayer, tlayer, seed, mask_kind, call):
    """Forward both on the same input, backward a random cotangent;
    returns (port out, jax out, port grads, jax grads) with the input's
    gradient under ``"x"``."""
    r = np.random.RandomState(seed)
    x = r.randn(B, S, E).astype(np.float32)
    cot = r.randn(B, S, E).astype(np.float32)
    jmask, tmask = _masks(mask_kind, seed)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = call(jlayer, jx, jmask)
    (jout * paddle.to_tensor(cot)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = call(tlayer, tx, tmask)
    (tout * torch.from_numpy(cot)).sum().backward()
    jg = {k: np.asarray(p.grad.numpy()) for k, p in
          jlayer.state_dict().items()}
    jg = {k: (g.T if g.ndim == 2 else g) for k, g in jg.items()}
    jg["x"] = np.asarray(jx.grad.numpy())
    tg = {k: p.grad.numpy() for k, p in tlayer.named_parameters()}
    tg["x"] = tx.grad.numpy()
    return tout.detach().numpy(), jout.numpy(), tg, jg


def _check(tout, jout, tg, jg):
    _close(tout, jout)
    assert set(tg) == set(jg)
    top = max(np.abs(g).max() for g in jg.values())
    for k, g in tg.items():
        want = jg[k]
        np.testing.assert_allclose(
            g, want, rtol=0, atol=1e-5 * np.abs(want).max() + 1e-6 * top,
            err_msg=k)


MASKS = pytest.mark.parametrize("mask_kind", [None, "bool", "additive"],
                                ids=["nomask", "bool", "additive"])


@MASKS
def test_multi_head_attention_matches_jax(mask_kind):
    paddle.seed(1)
    jm = paddle.nn.MultiHeadAttention(E, H)
    tm = MultiHeadAttention(E, H, device="cpu")
    _load(tm, jm)
    jm.eval()
    tm.eval()
    call = lambda m, x, mask: m(x, attn_mask=mask)
    _check(*_run_both(jm, tm, 11, mask_kind, call))


def test_fused_qkv_equals_separate_projections():
    """Self-attention's one [3E, E] product against the three
    projections (the same query passed as a separate key and value)."""
    tm = MultiHeadAttention(E, H, device="cpu").eval()
    x = torch.from_numpy(np.random.RandomState(2).randn(B, S, E).astype(
        np.float32))
    fused = tm(x)
    separate = tm(x, x.clone(), x.clone())
    torch.testing.assert_close(fused, separate, rtol=0, atol=1e-6)


@MASKS
@pytest.mark.parametrize("pre", [False, True], ids=["postnorm", "prenorm"])
def test_encoder_layer_matches_jax(pre, mask_kind):
    paddle.seed(3)
    jl = paddle.nn.TransformerEncoderLayer(E, H, 32, dropout=0.1,
                                           activation="gelu",
                                           normalize_before=pre)
    tl = TransformerEncoderLayer(E, H, 32, dropout=0.1, activation="gelu",
                                 normalize_before=pre, device="cpu")
    _load(tl, jl)
    jl.eval()
    tl.eval()
    call = lambda m, x, mask: m(x, mask)
    _check(*_run_both(jl, tl, 13, mask_kind, call))


def test_encoder_stacks_copies_and_matches_jax():
    paddle.seed(4)
    jenc = paddle.nn.TransformerEncoder(
        paddle.nn.TransformerEncoderLayer(E, H, 32, dropout=0.0), 2,
        paddle.nn.LayerNorm(E))
    from paddle_tpu_torch.nn import LayerNorm

    tenc = TransformerEncoder(
        TransformerEncoderLayer(E, H, 32, dropout=0.0, device="cpu"), 2,
        LayerNorm(E, device="cpu"))
    assert tenc.layers[0] is not tenc.layers[1]
    torch.testing.assert_close(tenc.layers[0].linear1.weight,
                               tenc.layers[1].linear1.weight, rtol=0, atol=0)
    _load(tenc, jenc)
    call = lambda m, x, mask: m(x, mask)
    _check(*_run_both(jenc, tenc, 14, "bool", call))


# (kwargs, label kind): the options of loss.py:26-63
CE_CASES = {
    "plain": (dict(), "int"),
    "ignore": (dict(ignore_index=3), "int"),
    "ignore_sum": (dict(reduction="sum"), "int"),
    "ignore_none": (dict(reduction="none"), "int"),
    "weight_mean": (dict(weight=True), "int"),
    "weight_sum": (dict(weight=True, reduction="sum"), "int"),
    "smoothing": (dict(label_smoothing=0.1), "int"),
    "smoothing_weight": (dict(label_smoothing=0.2, weight=True), "int"),
    "soft": (dict(soft_label=True), "soft"),
    "soft_smoothing": (dict(soft_label=True, label_smoothing=0.1), "soft"),
    "axis1": (dict(axis=1), "int_axis1"),
    "axis1_smoothing": (dict(axis=1, label_smoothing=0.1), "int_axis1"),
    "no_valid_row": (dict(), "all_ignored"),
}


def _ce_inputs(kind, seed, ignore_index=-100):
    r = np.random.RandomState(seed)
    n, c = 12, 7
    if kind == "int_axis1":
        logits = r.randn(3, c, 4).astype(np.float32) * 2
        label = r.randint(0, c, (3, 4)).astype(np.int64)
        label[0, 1] = -100
        return logits, label
    logits = r.randn(n, c).astype(np.float32) * 2
    if kind == "soft":
        soft = r.rand(n, c).astype(np.float32)
        return logits, soft / soft.sum(-1, keepdims=True)
    label = r.randint(0, c, n).astype(np.int64)
    label[::4] = ignore_index
    if kind == "all_ignored":
        label[:] = ignore_index
    return logits, label


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_matches_jax(case, dtype):
    kw, kind = CE_CASES[case]
    kw = dict(kw)
    logits, label = _ce_inputs(kind, 5, kw.get("ignore_index", -100))
    w = None
    if kw.pop("weight", False):
        w = np.random.RandomState(6).rand(logits.shape[-1]).astype(
            np.float32) + 0.5
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jt = paddle.to_tensor(np.asarray(jl), stop_gradient=False) \
        if dtype == "float32" else paddle.Tensor(jl)
    if dtype == "float32":
        tl.requires_grad_(True)
    want = JF.cross_entropy(jt, paddle.to_tensor(label),
                            weight=None if w is None else paddle.to_tensor(w),
                            **kw)
    got = F.cross_entropy(tl, torch.from_numpy(label),
                          weight=None if w is None else torch.from_numpy(w),
                          **kw)
    wv = np.asarray(want.numpy(), np.float32)
    gv = got.detach().float().numpy()
    assert gv.shape == wv.shape
    assert str(got.dtype) == "torch." + str(want._data.dtype)
    if dtype == "float32":
        np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-6)
        want.sum().backward()
        got.sum().backward()
        ref = np.asarray(jt.grad.numpy())
        np.testing.assert_allclose(tl.grad.numpy(), ref, rtol=0,
                                   atol=1e-6 * max(np.abs(ref).max(), 1.0))
    else:
        np.testing.assert_allclose(gv, wv, rtol=2.0 ** -7, atol=2.0 ** -8)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_embedding_linear_match_jax(approximate):
    r = np.random.RandomState(7)
    x = r.randn(5, 9).astype(np.float32) * 3
    want = jax.nn.gelu(jnp.asarray(x), approximate=approximate)
    got = F.gelu(torch.from_numpy(x), approximate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    table = r.randn(10, 4).astype(np.float32)
    ids = r.randint(0, 10, (3, 5)).astype(np.int64)
    ids[0, :2] = 2
    want = JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(table),
                        padding_idx=2)
    tw = torch.from_numpy(table).requires_grad_(True)
    got = F.embedding(torch.from_numpy(ids), tw, padding_idx=2)
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    got.sum().backward()
    assert not tw.grad[2].any() and tw.grad.sum() > 0
    w = r.randn(4, 6).astype(np.float32)          # paddle [in, out]
    b = r.randn(6).astype(np.float32)
    want = JF.linear(paddle.to_tensor(table), paddle.to_tensor(w),
                     paddle.to_tensor(b))
    got = F.linear(torch.from_numpy(table), torch.from_numpy(w.T.copy()),
                   torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
