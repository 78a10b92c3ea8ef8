"""float16 AMP through attention: the port's tiny BERT (hidden 32, 2
layers, 2 heads) under ``amp.auto_cast`` O1 and O2 in float16 against the
JAX package's under its ``auto_cast`` on the same weights, in eval mode
(no dropout): the MLM loss and every parameter's gradient; and
``jit.TrainStep(scaler=)`` skipping a step whose float16 backward
overflows (a loss scale of 2**40 drives the attention's dS and the
projections' gradients past 65504), as JAX's does.

Without a mask the port's attention runs the flash twin (f32 inside, P
and dS unrounded) and JAX's ``_sdpa_ref`` (f32 inside); the projections
round to float16 at the same places on both sides, in another
summation order.  Tolerances: the loss to 2**-8 relative (an f32 cross
entropy of float16 logits that differ by an ulp or two), each gradient
to 2**-5 of its largest magnitude plus 2**-9 of the model's largest
(float16 gradients: ulps of 2**-11 relative, summed over two layers).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import state_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import BertConfig, BertForMaskedLM
from paddle_tpu_torch.optimizer import SGD

from _torch_port_util import one_thread  # noqa: F401

TINY = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _models(seed):
    paddle.seed(seed)
    jcfg = JBertConfig(**TINY)
    jm = JBertForMaskedLM(jcfg)
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    tm = BertForMaskedLM(cfg, device="cpu")
    tm.load_state_dict(state_from_jax(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}, tm,
        device="cpu"))
    jm.eval()
    tm.eval()
    return cfg, jm, tm


def _batch(seed=0, b=2, s=10):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 100, (b, s)).astype(np.int64)
    types = r.randint(0, 2, (b, s)).astype(np.int64)
    labels = ids.copy()
    labels[:, ::2] = -100
    return ids, types, labels


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_bert_fp16_auto_cast_matches_jax(level):
    cfg, jm, tm = _models(seed=1)
    if level == "O2":
        jm = paddle.amp.decorate(models=jm, level="O2", dtype="float16")
        tm = amp.decorate(tm, level="O2", dtype="float16")
    ids, types, labels = _batch(1)
    with paddle.amp.auto_cast(level=level, dtype="float16"):
        jloss, _ = jm(paddle.to_tensor(ids), paddle.to_tensor(types),
                      labels=paddle.to_tensor(labels))
    jloss.backward()
    with amp.auto_cast(level=level, dtype="float16"):
        tloss, _ = tm(torch.from_numpy(ids), torch.from_numpy(types),
                      labels=torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                               rtol=2.0 ** -8)
    jg = {k: np.asarray(p.grad.numpy()).astype(np.float32)
          for k, p in jm.state_dict().items()}
    want = state_from_jax(jg, tm, device="cpu")
    top = max(t.abs().max().item() for t in want.values())
    for n, p in tm.named_parameters():
        assert p.grad.dtype == p.dtype == (torch.float16 if level == "O2"
                                           else torch.float32), n
        w = want[n].numpy()
        g = p.grad.float().numpy()
        assert np.isfinite(g).all(), n
        np.testing.assert_allclose(
            g, w, rtol=0, atol=2.0 ** -5 * np.abs(w).max() + 2.0 ** -9 * top,
            err_msg=n)


def test_scaler_skips_an_fp16_overflow_as_jax():
    """Three O1 float16 steps with a GradScaler; the second at a scale of
    2**40 overflows the float16 backward: both frameworks keep every
    parameter, halve the scale and count a bad step."""
    cfg, jm, tm = _models(seed=2)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    js = paddle.amp.GradScaler(**kw)
    ts = amp.GradScaler(**kw, device="cpu")
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jm.parameters())
    topt = SGD(learning_rate=0.1, parameters=tm.named_parameters(),
               device="cpu")

    def jloss(net, ids, types, labels):
        with paddle.amp.auto_cast(dtype="float16"):
            return net(ids, types, labels=labels)[0]

    def tloss(net, ids, types, labels):
        with amp.auto_cast(dtype="float16"):
            return net(ids, types, labels=labels)[0]

    jstep = paddle.jit.TrainStep(jm, jloss, jopt, scaler=js)
    tstep = TrainStep(tm, tloss, topt, scaler=ts, device="cpu")
    for step in range(3):
        ids, types, labels = _batch(step + 3)
        if step == 1:
            js.set_init_loss_scaling(2.0 ** 40)
            ts.set_init_loss_scaling(2.0 ** 40)
            before = {k: v.clone() for k, v in tm.state_dict().items()}
        jl = float(jstep(*(paddle.to_tensor(a)
                           for a in (ids, types, labels))))
        tl = tstep(*(torch.from_numpy(a)
                     for a in (ids, types, labels))).item()
        np.testing.assert_allclose(tl, jl, rtol=2.0 ** -8)
        assert ts.get_loss_scaling().item() == float(js._scale), step
        assert (int(ts._good_steps), int(ts._bad_steps)) == (
            int(js._good_steps), int(js._bad_steps)), step
        if step == 1:
            for k, v in tm.state_dict().items():
                assert torch.equal(v, before[k]), k
            assert ts.get_loss_scaling().item() == 2.0 ** 39
    assert all(torch.isfinite(p).all() for p in tm.parameters())
