"""The port's fused layers (``incubate.nn``), ``LookAhead``,
``ModelAverage``, ``identity_loss``, ``nn.RMSNorm`` and
``nn.functional.rms_norm``, the public flash functionals and
``inference.create_llm_engine`` against the JAX package on the CPU, at
d_model 64, 4 heads, FFN 128, on the same weights (``convert``).

Tolerance: f32 on both sides, the same terms in another order: 2e-5 of
the largest value of the reference (outputs, input gradients, and the
parameters after six optimizer steps).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate as jinc
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.serving.sharded.mesh_engine import MeshEngine

import paddle_tpu_torch.incubate as tinc
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import state_from_jax
from paddle_tpu_torch.inference import _mesh_shape, create_llm_engine
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

from _torch_port_util import (TINY, one_thread,  # noqa: F401
                              torch_config)

FRAC = 2e-5


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t, np.float32)


def _near(got, want, frac=FRAC):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


# name: (layer, kwargs, src_mask)
LAYER_CASES = {
    "mha_post": ("FusedMultiHeadAttention", dict(embed_dim=64, num_heads=4),
                 False),
    "ffn_pre": ("FusedFeedForward",
                dict(d_model=64, dim_feedforward=128,
                     normalize_before=True), False),
    "encoder_post": ("FusedTransformerEncoderLayer",
                     dict(d_model=64, nhead=4, dim_feedforward=128), False),
    "encoder_pre_mask": ("FusedTransformerEncoderLayer",
                         dict(d_model=64, nhead=4, dim_feedforward=128,
                              normalize_before=True), True),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_fused_layers_match_jax(case):
    """JAX's initial weights carried across (their shapes are the
    port's), dropout 0, train mode: the output and the input gradient of
    a weighted sum; the port's own initial weights lie inside the Xavier
    bound of JAX's fans."""
    name, kw, masked = LAYER_CASES[case]
    drop = {"FusedMultiHeadAttention": dict(dropout_rate=0.0,
                                            attn_dropout_rate=0.0)}.get(
        name, dict(dropout_rate=0.0))
    paddle.seed(3)
    jl = getattr(jinc.nn, name)(**kw, **drop)
    tl = getattr(tinc.nn, name)(**kw, **drop, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    for k, v in tl.state_dict().items():
        if v.dim() > 1:                 # Xavier-uniform over JAX's fans
            fin, fout = ((v.shape[0], v.shape[1]) if v.dim() == 2 else
                         (v.shape[1] * v[0, 0].numel(),
                          v.shape[0] * v[0, 0].numel()))
            assert v.abs().max() <= np.sqrt(6.0 / (fin + fout))
            assert v.std() > 0.3 * np.sqrt(2.0 / (fin + fout))
    tl.load_state_dict(state_from_jax(state, tl, device="cpu"))
    r = np.random.RandomState(4)
    x = r.randn(2, 6, 64).astype(np.float32)
    g = r.randn(2, 6, 64).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x).requires_grad_()
    jx.stop_gradient = False
    args_j, args_t = (), ()
    if masked:
        m = np.zeros((2, 1, 6, 6), np.float32)
        m[1, ..., 4:] = -1e9
        args_j, args_t = (paddle.to_tensor(m),), (torch.from_numpy(m),)
    jo, to = jl(jx, *args_j), tl(tx, *args_t)
    _near(to, jo)
    (jo * paddle.to_tensor(g)).sum().backward()
    (to * torch.from_numpy(g)).sum().backward()
    _near(tx.grad, jx.grad)


def _regression():
    r = np.random.RandomState(5)
    return (r.randn(16, 4).astype(np.float32),
            r.randn(16, 3).astype(np.float32))


def _pair(seed):
    paddle.seed(seed)
    jm = jnn.Linear(4, 3)
    tm = tnn.Linear(4, 3, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.array(jm.weight.numpy())))
        tm.bias.copy_(torch.from_numpy(np.array(jm.bias.numpy())))
    return jm, tm


def _step(jm, tm, jopt, topt, x, y):
    jl = ((jm(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
    jl.backward()
    jopt.step()
    jopt.clear_grad()
    tl = ((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    tl.backward()
    topt.step()
    topt.clear_grad()


def _same_params(jm, tm):
    _near(tm.weight, jm.weight)
    _near(tm.bias, jm.bias)


def test_lookahead_matches_jax():
    """LookAhead(alpha 0.4, k 3) over Momentum(0.1): the parameters after
    each of 6 steps (two slow-weight syncs)."""
    x, y = _regression()
    jm, tm = _pair(6)
    jopt = jinc.LookAhead(paddle.optimizer.Momentum(
        0.1, 0.9, parameters=jm.parameters()), alpha=0.4, k=3)
    topt = tinc.LookAhead(Momentum(0.1, 0.9, parameters=tm.parameters(),
                                   device="cpu"), alpha=0.4, k=3)
    for _ in range(6):
        _step(jm, tm, jopt, topt, x, y)
        _same_params(jm, tm)


def test_model_average_matches_jax():
    """ModelAverage over 6 Momentum steps: the averaged parameters under
    ``apply()``, the trained ones after the context restores them, and
    ``apply(need_restore=False)`` then ``restore()``."""
    x, y = _regression()
    jm, tm = _pair(7)
    jopt = paddle.optimizer.Momentum(0.1, 0.9, parameters=jm.parameters())
    topt = Momentum(0.1, 0.9, parameters=tm.parameters(), device="cpu")
    javg = jinc.ModelAverage(parameters=jm.parameters())
    tavg = tinc.ModelAverage(parameters=tm.parameters())
    for _ in range(6):
        _step(jm, tm, jopt, topt, x, y)
        javg.step()
        tavg.step()
    trained = tm.weight.detach().clone()
    with javg.apply(), tavg.apply():
        _same_params(jm, tm)
    _same_params(jm, tm)
    assert torch.equal(tm.weight.detach(), trained)
    javg.apply(need_restore=False)
    tavg.apply(need_restore=False)
    _same_params(jm, tm)
    assert not torch.equal(tm.weight, trained)
    javg.restore()
    tavg.restore()
    _same_params(jm, tm)
    assert torch.equal(tm.weight.detach(), trained)


def test_identity_loss_and_rms_norm_match_jax():
    """``identity_loss`` in its three reductions; ``nn.RMSNorm`` and
    ``nn.functional.rms_norm`` (weight and bias over the last two axes)."""
    r = np.random.RandomState(8)
    x = r.randn(2, 5, 8).astype(np.float32)
    for red in ("none", "sum", "mean", 0, 1):
        _near(tinc.identity_loss(torch.from_numpy(x), red),
              jinc.identity_loss(paddle.to_tensor(x), red))
    paddle.seed(0)
    jl, tl = jnn.RMSNorm(8), tnn.RMSNorm(8, device="cpu")
    w = r.randn(8).astype(np.float32)
    jl.weight.set_value(w)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    _near(tl(torch.from_numpy(x)), jl(paddle.to_tensor(x)))
    w2, b2 = r.randn(5, 8).astype(np.float32), r.randn(8).astype(np.float32)
    _near(TF.rms_norm(torch.from_numpy(x), torch.from_numpy(w2),
                      torch.from_numpy(b2), 1e-5, 1),
          JF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w2),
                      paddle.to_tensor(b2), 1e-5, 1))


def test_flash_functionals_match_jax():
    """``flash_attention`` (causal, ``(out, None)``) and
    ``flash_attn_unpadded`` over three packed segments of 5, 2 and 5
    tokens (the flash twin here); with ``scale`` the port scales the
    scores, which JAX's ``flash_attn_unpadded`` drops (ROADMAP.md Queue
    3: JAX's output with scale 0.5 equals its output without)."""
    r = np.random.RandomState(9)
    q, k, v = (r.randn(1, 5, 4, 16).astype(np.float32) for _ in range(3))
    jo, jn = JF.flash_attention(*map(paddle.to_tensor, (q, k, v)),
                                causal=True)
    to, tn = TF.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True)
    assert jn is None and tn is None
    _near(to, jo)
    pq, pk, pv = (r.randn(12, 4, 16).astype(np.float32) for _ in range(3))
    cu = np.array([0, 5, 7, 12], np.int32)
    jo, _ = JF.flash_attn_unpadded(*map(paddle.to_tensor, (pq, pk, pv, cu,
                                                           cu)), 5, 5,
                                   causal=True)
    to, _ = TF.flash_attn_unpadded(*map(torch.from_numpy, (pq, pk, pv, cu,
                                                           cu)), 5, 5,
                                   causal=True)
    _near(to, jo)
    jscaled, _ = JF.flash_attn_unpadded(
        *map(paddle.to_tensor, (pq, pk, pv, cu, cu)), 5, 5, scale=0.5,
        causal=True)
    np.testing.assert_array_equal(_np(jscaled), _np(jo))
    tscaled, _ = TF.flash_attn_unpadded(
        *map(torch.from_numpy, (pq, pk, pv, cu, cu)), 5, 5, scale=0.5,
        causal=True)
    want = []
    for a, b in zip(cu[:-1], cu[1:]):         # dense causal, scores * 0.5
        s = np.einsum("qhd,khd->hqk", pq[a:b], pk[a:b]).astype(
            np.float64) * 0.5
        s = np.where(np.tri(b - a, dtype=bool), s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        want.append(np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True),
                              pv[a:b]))
    _near(tscaled, np.concatenate(want))
    with TF.sdp_kernel(enable_math=True):
        pass


def test_create_llm_engine():
    """The port's ``Engine`` on the model's device, its config from the
    keyword arguments, the same greedy stream as an ``Engine`` built
    directly; ``tp=1`` too; tensor parallelism raises
    ``NotImplementedError``; the knob pair is normalized and refused as
    JAX's ``MeshEngine._norm_mesh_knob`` does."""
    from paddle_tpu_torch.models import GPTForCausalLM

    m = GPTForCausalLM(torch_config(TINY), device="cpu", seed=0)
    eng = create_llm_engine(m, num_slots=2, max_seq_len=64)
    assert type(eng) is Engine and eng.config.num_slots == 2
    sp = SamplingParams(max_new_tokens=6)
    want = Engine(m, EngineConfig(num_slots=2, max_seq_len=64),
                  device="cpu").generate([5, 6, 7], sp)
    assert eng.generate([5, 6, 7], sp) == want
    assert type(create_llm_engine(m, tp=1, max_seq_len=64)) is Engine
    for kw in (dict(tp=2), dict(mesh_shape=(1, 4))):
        with pytest.raises(NotImplementedError, match="sharded"):
            create_llm_engine(m, **kw)
    for ms, tp in (((1, 2), None), (None, 3), ((2, 1), None), ((1, 2), 4),
                   ((1, 0), None), ((1, 2, 3), None), ("ab", None)):
        try:
            want = MeshEngine._norm_mesh_knob(ms, tp)
        except ValueError:
            with pytest.raises(ValueError):
                _mesh_shape(ms, tp)
            continue
        assert _mesh_shape(ms, tp) == want
