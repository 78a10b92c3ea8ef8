"""The port's BERT against the JAX package's on the same weights
(``convert.state_from_jax``), in f32 on the CPU, on the tiny
config of ``tests/test_models.py`` ``TestBert`` (hidden 32, 2 layers, 2
heads): the MLM logits, loss and every parameter's gradient in
``eval()`` (no dropout), with and without a padding mask;
``BertForSequenceClassification`` likewise; the additive mask of
``tests/test_models.py:88-100``; the tied MLM decoder as one parameter;
the converter's key and shape checks; and three AdamW steps through
``jit.TrainStep`` against ``paddle.jit.TrainStep`` with dropout 0.

Without a mask the port's attention runs the flash kernels' plain twin
and JAX's runs ``_sdpa_ref``; with one, both run ``_sdpa_ref``'s terms.
Tolerances: the same f32 arithmetic in another summation order through
two layers: logits to 1e-5 of their largest magnitude, losses to 1e-5
relative, gradients to 1e-4 of each tensor's largest magnitude (the
loss's gradient passes back through two layers' LayerNorms, each
rounding in its own order) plus 1e-6 of the model's largest gradient
(the key bias's gradient is 0 in exact arithmetic, f32 noise on both
sides), the parameters after three steps to 2e-5
of each tensor's largest magnitude plus 1 % of a step's learning rate
(Adam divides a gradient by its own running norm; biases start at 0).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from paddle_tpu.models.bert import (
    BertForSequenceClassification as JBertForSequenceClassification,
)
from paddle_tpu_torch.convert import state_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    BERT_BASE, BertConfig, BertForMaskedLM, BertForSequenceClassification,
)
from paddle_tpu_torch.optimizer import AdamW

from _torch_port_util import one_thread  # noqa: F401

TINY = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _jax_model(cls, seed, num_classes=None, **kw):
    paddle.seed(seed)
    cfg = JBertConfig(**TINY, **kw)
    m = cls(cfg) if num_classes is None else cls(cfg, num_classes)
    return cfg, m


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _port(cls, jcfg, jm, num_classes=None):
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    kw = {} if num_classes is None else {"num_classes": num_classes}
    tm = cls(cfg, device="cpu", **kw)
    tm.load_state_dict(state_from_jax(_state(jm), tm, device="cpu"))
    return cfg, tm


def _batch(b=2, s=10, seed=0, vocab=100):
    r = np.random.RandomState(seed)
    ids = r.randint(0, vocab, (b, s)).astype(np.int64)
    types = r.randint(0, 2, (b, s)).astype(np.int64)
    labels = ids.copy()
    labels[:, ::2] = -100                 # score odd positions only
    return ids, types, labels


def _grads_close(tm, jm):
    """Every port gradient against the JAX parameter's (one layout:
    paddle's)."""
    jg = {k: np.asarray(p.grad.numpy()) for k, p in jm.state_dict().items()}
    tg = state_from_jax(jg, tm, device="cpu")
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(tg)
    top = max(t.abs().max().item() for t in tg.values())
    for n, g in got.items():
        want = tg[n].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-6 * top,
                                   err_msg=n)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_mlm_logits_loss_and_grads_match_jax(masked):
    cfg, jm = _jax_model(JBertForMaskedLM, seed=1)
    _, tm = _port(BertForMaskedLM, cfg, jm)
    jm.eval()
    tm.eval()
    ids, types, labels = _batch(seed=1)
    mask = None
    if masked:
        mask = np.ones(ids.shape, np.float32)
        mask[0, 7:] = 0.0
        mask[1, 4:] = 0.0
    jloss, jlogits = jm(paddle.to_tensor(ids), paddle.to_tensor(types),
                        None if mask is None else paddle.to_tensor(mask),
                        labels=paddle.to_tensor(labels))
    jloss.backward()
    tloss, tlogits = tm(torch.from_numpy(ids), torch.from_numpy(types),
                        None if mask is None else torch.from_numpy(mask),
                        labels=torch.from_numpy(labels))
    tloss.backward()
    want = jlogits.numpy()
    assert tlogits.shape == (2, 10, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), rtol=1e-5)
    _grads_close(tm, jm)


def test_sequence_classification_matches_jax():
    cfg, jm = _jax_model(JBertForSequenceClassification, seed=2,
                         num_classes=3)
    _, tm = _port(BertForSequenceClassification, cfg, jm, num_classes=3)
    jm.eval()
    tm.eval()
    ids, types, _ = _batch(b=4, seed=2)
    cls = np.array([0, 2, 1, 2], np.int64)
    jloss, jlogits = jm(paddle.to_tensor(ids), paddle.to_tensor(types),
                        labels=paddle.to_tensor(cls))
    jloss.backward()
    tloss, tlogits = tm(torch.from_numpy(ids), torch.from_numpy(types),
                        labels=torch.from_numpy(cls))
    tloss.backward()
    want = jlogits.numpy()
    np.testing.assert_allclose(tlogits.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), rtol=1e-5)
    _grads_close(tm, jm)


def test_padding_mask_hides_masked_tokens():
    """``tests/test_models.py:88-100``: with tokens 3-5 masked out,
    changing token 4 leaves positions 0-2 as they were; and the
    additive mask is ``(1 - m) * -1e30`` in f32."""
    cfg = BertConfig(vocab_size=50, hidden_size=32, num_hidden_layers=1,
                     num_attention_heads=2, intermediate_size=64,
                     max_position_embeddings=32)
    m = BertForMaskedLM(cfg, device="cpu", seed=3).eval()
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 50, (1, 6)))
    mask = torch.tensor([[1, 1, 1, 0, 0, 0]], dtype=torch.float32)
    with torch.no_grad():
        out1 = m(ids, attention_mask=mask)
        ids2 = ids.clone()
        ids2[0, 4] = (ids2[0, 4] + 7) % 50
        out2 = m(ids2, attention_mask=mask)
    np.testing.assert_allclose(out1[0, :3].numpy(), out2[0, :3].numpy(),
                               atol=1e-4)
    assert not torch.allclose(out1[0, 4], out2[0, 4])
    seen = {}
    enc = m.bert.encoder

    def grab(mod, args, kwargs):
        seen["mask"] = args[1] if len(args) > 1 else kwargs.get("src_mask")

    h = enc.register_forward_pre_hook(grab, with_kwargs=True)
    with torch.no_grad():
        m(ids, attention_mask=mask.to(torch.int64))
    h.remove()
    got = seen["mask"]
    assert got.dtype == torch.float32 and got.shape == (1, 1, 1, 6)
    assert torch.equal(got.reshape(-1)[:3], torch.zeros(3))
    assert torch.equal(got.reshape(-1)[3:], torch.full((3,), -1e30))


def test_tied_decoder_is_the_embedding_parameter():
    """One ``nn.Parameter`` serves the embedding and the MLM decoder, in
    the state dict once; its gradient is the sum of both uses, and the
    tie survives ``.to(dtype)`` and ``deepcopy``."""
    cfg = BertConfig(**TINY)
    m = BertForMaskedLM(cfg, device="cpu", seed=4)
    emb = m.bert.embeddings.word_embeddings.weight
    assert m.cls.decoder_weight is emb
    assert set(m.state_dict()) == set(
        _state(_jax_model(JBertForMaskedLM, seed=4)[1]))
    assert sum(p is emb for p in m.parameters()) == 1
    ids, types, labels = (torch.from_numpy(a) for a in _batch(seed=4))
    loss, _ = m(ids, types, labels=labels)
    loss.backward()
    both = emb.grad.clone()
    # the decoder's share alone: the same loss with the embedding
    # lookup's weight detached
    m.zero_grad()
    w = m.bert.embeddings.word_embeddings
    saved = w.weight
    w._parameters["weight"] = saved.detach()
    loss_d, _ = m(ids, types, labels=labels)
    w._parameters["weight"] = saved
    loss_d.backward()
    decoder_only = saved.grad.clone()
    assert decoder_only.abs().sum() > 0
    assert not torch.allclose(both, decoder_only)
    for copy_of in (copy.deepcopy(m), m.to(torch.bfloat16)):
        assert copy_of.cls.decoder_weight is \
            copy_of.bert.embeddings.word_embeddings.weight


def test_converter_checks_keys_and_shapes():
    cfg, jm = _jax_model(JBertForMaskedLM, seed=5)
    tcfg = BertConfig(**dataclasses.asdict(cfg))
    js = _state(jm)
    tm = BertForMaskedLM(tcfg, device="cpu")
    assert {k: v.shape for k, v in js.items()} == {
        k: tuple(v.shape) for k, v in tm.state_dict().items()}
    out = state_from_jax(js, tm, device="cpu")
    w = "bert.encoder.layers.0.linear1.weight"
    np.testing.assert_array_equal(out[w].numpy(), js[w])
    e = "bert.embeddings.word_embeddings.weight"
    np.testing.assert_array_equal(out[e].numpy(), js[e])
    with pytest.raises(KeyError, match="missing"):
        state_from_jax({k: v for k, v in js.items() if k != e}, tm,
                       device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        state_from_jax(dict(js, **{"cls.decoder_weight": js[e]}), tm,
                       device="cpu")
    with pytest.raises(ValueError, match="linear1"):
        state_from_jax(dict(js, **{w: js[w].T}), tm, device="cpu")


def test_bert_base_is_the_published_width():
    assert (BERT_BASE.vocab_size, BERT_BASE.hidden_size,
            BERT_BASE.num_hidden_layers, BERT_BASE.num_attention_heads,
            BERT_BASE.intermediate_size, BERT_BASE.hidden_act,
            BERT_BASE.hidden_dropout_prob,
            BERT_BASE.attention_probs_dropout_prob,
            BERT_BASE.layer_norm_eps) == (30522, 768, 12, 12, 3072, "gelu",
                                          0.1, 0.1, 1e-12)
    m = BertForMaskedLM(BERT_BASE, device="cpu", seed=0)
    n = sum(v.numel() for v in m.state_dict().values())
    assert n == 109_514_298         # BERT-base MLM, the decoder tied


def _loss_fn(net, ids, types, labels):
    loss, _ = net(ids, types, labels=labels)
    return loss


def test_three_adamw_train_steps_match_jax_train_step():
    cfg, jm = _jax_model(JBertForMaskedLM, seed=6, **NO_DROPOUT)
    tcfg, tm = _port(BertForMaskedLM, cfg, jm)
    jm.train()
    tm.train()
    # epsilon 1e-6, BERT's own (Devlin et al. 2019): the key bias's
    # gradient is f32 noise (~1e-9) on both sides, and Adam's first step
    # moves it by lr * g / (|g| + eps), which at 1e-8 is a random ~10 %
    # of a step
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, weight_decay=0.01,
              multi_precision=True)
    lr = 1e-3
    jopt = paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=jm.parameters(), **kw)
    topt = AdamW(learning_rate=lr, parameters=tm.named_parameters(),
                 device="cpu", **kw)
    jstep = paddle.jit.TrainStep(jm, _loss_fn, jopt)
    tstep = TrainStep(tm, _loss_fn, topt, device="cpu")
    ids, types, labels = _batch(b=2, s=12, seed=6)
    jb = [paddle.to_tensor(a) for a in (ids, types, labels)]
    tb = [torch.from_numpy(a) for a in (ids, types, labels)]
    losses = []
    for _ in range(3):
        jl, tl = float(jstep(*jb).numpy()), tstep(*tb).item()
        losses.append(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert losses[2] < losses[0]
    want = state_from_jax(_state(jm), tm, device="cpu")
    for k, p in tm.state_dict().items():
        w = want[k].numpy()
        np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max() + 0.01 * lr,
                                   err_msg=k)
