"""Recompute in the port (``distributed.recompute``, the GPT's
``use_recompute``): with the hidden dropout on (p = 0.1), two
``jit.TrainStep`` AdamW steps of a tiny GPT with ``use_recompute``
give the losses, gradients and parameters of the same steps without it,
bit for bit, and leave the counter stream where it would be;
``recompute_sequential`` over a few layers equals running them; and
with dropout 0 the port's recomputed GPT matches the JAX package's
recomputed GPT (``paddle_tpu/models/gpt.py:262-265``) on the same
weights: loss to 1e-5 relative, gradients to 1e-4 of each tensor's
largest magnitude (the same f32 arithmetic in another order through two
layers).

JAX's recompute leaves the stream where it found it, so each
recomputed layer there draws the same keys; the port's advances it as
the layers would without recompute, which is what makes recompute and
no recompute equal.
"""

import dataclasses

import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import random as prandom
from paddle_tpu_torch.distributed import recompute, recompute_sequential
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTForCausalLM
from paddle_tpu_torch.nn import Dropout, Linear
from paddle_tpu_torch.optimizer import AdamW

from _torch_port_util import (  # noqa: F401
    TINY, jax_model, one_thread, port_model, torch_config,
)


def _loss_fn(net, ids):
    loss, _ = net(ids, labels=ids)
    return loss


def _run(use_recompute, ids):
    cfg = dataclasses.replace(torch_config(TINY), hidden_dropout_prob=0.1,
                              use_recompute=use_recompute)
    model = GPTForCausalLM(cfg, device="cpu", seed=3).train()
    opt = AdamW(learning_rate=1e-2, parameters=model.named_parameters(),
                device="cpu")
    prandom.seed(11)
    losses, grads = [], []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = _loss_fn(model, ids)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        losses.append(loss.detach())
        opt.step()
    step = TrainStep(model, _loss_fn, opt, device="cpu")
    losses.append(step(ids))
    return losses, grads, model.state_dict(), prandom.get_rng_state()


def test_recompute_equals_no_recompute_bit_for_bit_with_dropout():
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, TINY.vocab_size, (2, 16)))
    plain = _run(False, ids)
    remat = _run(True, ids)
    for a, b in zip(plain[0], remat[0]):
        assert torch.equal(a, b)
    for ga, gb in zip(plain[1], remat[1]):
        for n in ga:
            assert torch.equal(ga[n], gb[n]), n
    for n, p in plain[2].items():
        assert torch.equal(p, remat[2][n]), n
    # 2 layers x 2 dropouts x 3 steps: every forward key taken once
    assert plain[3] == remat[3] == (11, 12)
    # the dropout did something: eval's loss differs
    assert not torch.equal(plain[0][0], _run_eval(ids))


def _run_eval(ids):
    cfg = dataclasses.replace(torch_config(TINY), hidden_dropout_prob=0.1)
    model = GPTForCausalLM(cfg, device="cpu", seed=3).eval()
    with torch.no_grad():
        return _loss_fn(model, ids)


def test_recompute_sequential_equals_the_layers():
    prandom.seed(2)
    layers = [Linear(8, 8, device="cpu") for _ in range(4)]
    drops = [Dropout(0.2) for _ in range(4)]
    seq = [m for pair in zip(layers, drops) for m in pair]
    x = torch.randn(3, 8, requires_grad=True)

    def grads(run):
        for layer in layers:
            layer.weight.grad = None
        x.grad = None
        prandom.seed(9)
        out = run()
        out.square().sum().backward()
        return out.detach(), x.grad.clone(), [
            layer.weight.grad.clone() for layer in layers]

    def plain():
        h = x
        for m in seq:
            h = m(h)
        return h

    want = grads(plain)
    for segments in (1, 2, 4):
        got = grads(lambda: recompute_sequential({"segments": segments},
                                                 seq, x))
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        for a, b in zip(got[2], want[2]):
            assert torch.equal(a, b)
    out = recompute(lambda h: seq[0](h), x, use_reentrant=True)
    assert torch.equal(out, seq[0](x))


def test_recomputed_gpt_matches_jax():
    cfg = dataclasses.replace(TINY, use_recompute=True)
    jm = jax_model(cfg, seed=4)
    tm = port_model(TINY, jm)
    tm.config = dataclasses.replace(tm.config, use_recompute=True)
    jm.train()
    tm.train()
    ids = np.random.RandomState(4).randint(0, TINY.vocab_size,
                                           (2, 12)).astype(np.int64)
    jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jloss.backward()
    tloss = _loss_fn(tm, torch.from_numpy(ids))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), rtol=1e-5)
    jg = {k: np.asarray(p.grad.numpy()) for k, p in jm.state_dict().items()}
    for n, p in tm.named_parameters():
        want = jg[n]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=n)
