"""The port's training path against the JAX package's on the same
weights (``convert.state_dict_from_jax``), in f32 on the CPU: the LM loss
of ``GPTForCausalLM.forward(ids, labels)`` (unfused and the chunked
fused LM-head loss, tied and untied embeddings), and three
``jit.TrainStep`` steps of TINY and TINY_GQA with AdamW (LLaMA-2's
betas, eps and decay), ``ClipGradByGlobalNorm(1.0)`` and a LinearWarmup
into CosineAnnealingDecay schedule, against ``paddle.jit.TrainStep``.
The labels are the ids themselves, unshifted, as ``bench.py`` feeds
them, with a few rows set to the ignore index -100.

Tolerances: the same f32 arithmetic through two layers in another
summation order (attention by the plain flash twins on this side, by
XLA's dense softmax on the JAX side): losses agree to 1e-5 relative,
and the parameters after three steps to 2e-5 of each tensor's largest
magnitude (Adam divides each gradient by its own running norm, so an
f32-ulp difference in a gradient moves its update by about as much).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.ops import kernel_launches

from _torch_port_util import (  # noqa: F401
    TINY, TINY_GQA, jax_model, one_thread, port_model,
)

FUSED = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "unfused"])
OPT = dict(beta1=0.9, beta2=0.95, epsilon=1e-5, weight_decay=0.1,
           multi_precision=True)


def _batch(cfg, b=2, s=16, seed=0):
    ids = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int64)
    labels = ids.copy()
    labels[0, :3] = -100
    labels[1, -2:] = -100
    return ids, labels


def _loss_fn(net, ids, labels):
    loss, _ = net(ids, labels=labels)
    return loss


def _models(cfg, fused, seed):
    cfg = dataclasses.replace(cfg, fused_lm_loss=fused)
    jm = jax_model(cfg, seed=seed)
    tm = port_model(cfg, jm)
    return cfg, jm, tm


@FUSED
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_forward_loss_matches_jax(fused, tied):
    cfg, jm, tm = _models(dataclasses.replace(TINY, tie_word_embeddings=tied),
                          fused, seed=1)
    ids, labels = _batch(cfg, seed=1)
    jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert (logits is None) == (jlogits is None) == fused
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), rtol=1e-5)
    if not fused:
        np.testing.assert_allclose(logits.numpy(), jlogits.numpy(), rtol=0,
                                   atol=1e-4)


@FUSED
@pytest.mark.parametrize("cfg", [TINY, TINY_GQA], ids=["mha", "gqa"])
def test_three_train_steps_match_jax_train_step(cfg, fused):
    cfg, jm, tm = _models(cfg, fused, seed=2)
    jm.train()
    tm.train()
    jsched = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.CosineAnnealingDecay(1e-2, T_max=4), 2, 0.0, 1e-2)
    tsched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-2, T_max=4), 2,
                              0.0, 1e-2)
    jopt = paddle.optimizer.AdamW(
        learning_rate=jsched, parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **OPT)
    topt = AdamW(learning_rate=tsched, parameters=tm.named_parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0), device="cpu", **OPT)
    jstep = paddle.jit.TrainStep(jm, _loss_fn, jopt)
    tstep = TrainStep(tm, _loss_fn, topt, device="cpu")
    ids, labels = _batch(cfg, seed=3)
    jb = (paddle.to_tensor(ids), paddle.to_tensor(labels))
    tb = (torch.from_numpy(ids), torch.from_numpy(labels))
    losses = []
    for _ in range(3):
        jl, tl = float(jstep(*jb).numpy()), tstep(*tb).item()
        losses.append(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        jsched.step()
        tsched.step()
    assert losses[2] < losses[0]
    assert topt._step_count == 3
    assert all(p.grad is None for p in tm.parameters())
    js = {k: v.numpy() for k, v in jm.state_dict().items()}
    for k, p in tm.state_dict().items():
        want = js[k].T if p.dim() == 2 and k != "model.embed_tokens.weight" \
            else js[k]
        np.testing.assert_allclose(p.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


def test_bf16_train_step_keeps_dtypes_and_master_weights():
    cfg, jm, tm = _models(TINY_GQA, True, seed=4)
    tm = tm.to(torch.bfloat16).train()
    opt = AdamW(learning_rate=1e-2, parameters=tm.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), device="cpu", **OPT)
    step = TrainStep(tm, _loss_fn, opt, device="cpu")
    ids, labels = (torch.from_numpy(a) for a in _batch(cfg, seed=5))
    before = kernel_launches()
    losses = [step(ids, labels).item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    assert kernel_launches() == before      # CPU: plain twins, uncounted
    for p in tm.parameters():
        st = opt._accumulators[id(p)]
        assert p.dtype == torch.bfloat16
        assert st["master_weight"].dtype == st["moment1"].dtype == \
            torch.float32
        torch.testing.assert_close(st["master_weight"].to(torch.bfloat16),
                                   p.detach(), rtol=0, atol=0)


def test_fused_loss_on_an_indivisible_row_count():
    """N = 2 * 1031 rows (1031 is prime), 64-row chunks with a short last
    one: the loss and its gradients equal the unfused loss."""
    from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    n, h, v = 2062, 8, 11
    r = np.random.RandomState(6)
    hid = torch.from_numpy(r.randn(n, h).astype(np.float32))
    w = torch.from_numpy(r.randn(v, h).astype(np.float32))
    y = torch.from_numpy(r.randint(0, v, n))
    y[::7] = -100
    grads = []
    for fused in (True, False):
        th, tw = hid.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if fused:
            loss = fused_linear_cross_entropy(th, tw, y, transpose_weight=True,
                                              chunk_rows=64)
        else:
            loss = torch.nn.functional.cross_entropy(th @ tw.t(), y,
                                                     ignore_index=-100)
        loss.backward()
        grads.append((loss.detach(), th.grad, tw.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
