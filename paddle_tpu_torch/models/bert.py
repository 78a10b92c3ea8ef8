"""BERT, the counterpart of ``paddle_tpu/models/bert.py`` (BASELINE
config 2: BERT-base masked-LM pretraining).

The encoder is ``nn.TransformerEncoder``: post-norm layers whose
LayerNorms (26 forwards a BertForMaskedLM step: the embeddings', two a
layer, the MLM head's) run the LayerNorm kernels, and whose attention
runs the flash kernels when there is no mask and no training dropout,
else JAX's plain f32 path (``nn.functional.sdpa_plain``).  The padding
mask is JAX's additive ``(1 - m) * -1e30`` in f32, ``[B, 1, 1, S]``.

Parameter names match the JAX model's ``state_dict()`` key for key
(``convert.bert_state_dict_from_jax``).  The MLM decoder multiplies by the
word-embedding ``nn.Parameter`` itself, untransposed (``bert.py:106-114``):
one parameter, whose gradient sums both uses.  The head holds it outside
its own parameters, so ``state_dict()`` lists it once, under
``bert.embeddings.word_embeddings.weight``, as JAX's does.

Models are built on ``device`` (``cuda`` unless the caller passes
``"cpu"``) in ``dtype``.  Initial values come from the port's counter
stream (:mod:`paddle_tpu_torch.random`): with ``seed`` from a private
stream seeded by it, else from the thread's stream (``random.seed``).
As in JAX, embeddings are N(0, initializer_range), the other matrices
Xavier-normal, and the encoder's layers are copies of one layer.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch import nn

from .. import random as _random
from ..device import resolve_device
from ..nn import functional as F
from ..nn.activation import GELU, Tanh
from ..nn.common import Dropout, Embedding, Linear
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(hidden_size=1024, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=4096)


def _init_stream(seed):
    return (contextlib.nullcontext() if seed is None
            else _random.fork_rng(seed))


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        with torch.no_grad():
            for e in (self.word_embeddings, self.position_embeddings,
                      self.token_type_embeddings):
                e.weight.normal_(0.0, c.initializer_range,
                                 generator=_random.next_generator(
                                     e.weight.device))
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device).expand(b, s)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Module):
    def __init__(self, c: BertConfig, device=None, dtype=None):
        super().__init__()
        self.dense = Linear(c.hidden_size, c.hidden_size, device=device,
                            dtype=dtype)
        self.activation = Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class BertModel(nn.Module):
    def __init__(self, config: BertConfig = None, with_pool=True,
                 device=None, dtype=torch.float32, seed=None):
        super().__init__()
        c = config or BertConfig()
        dev = resolve_device(device)
        self.config = c
        with _init_stream(seed):
            self.embeddings = BertEmbeddings(c, dev, dtype)
            enc_layer = TransformerEncoderLayer(
                c.hidden_size, c.num_attention_heads, c.intermediate_size,
                dropout=c.hidden_dropout_prob, activation=c.hidden_act,
                attn_dropout=c.attention_probs_dropout_prob,
                layer_norm_eps=c.layer_norm_eps, device=dev, dtype=dtype)
            self.encoder = TransformerEncoder(enc_layer, c.num_hidden_layers)
            self.pooler = BertPooler(c, dev, dtype) if with_pool else None

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """``(sequence [B, S, H], pooled [B, H] or None)``;
        ``attention_mask`` [B, S] is 1 for a visible token, 0 for
        padding."""
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            m = attention_mask[:, None, None, :].to(torch.float32)
            mask = (1.0 - m) * -1e30
        seq = self.encoder(x, mask)
        pooled = self.pooler(seq) if self.pooler is not None else None
        return seq, pooled


class BertLMPredictionHead(nn.Module):
    def __init__(self, c: BertConfig, embedding_weights, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.transform = Linear(c.hidden_size, c.hidden_size, **kw)
        self.activation = GELU()
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        # the tied [vocab, hidden] word embedding, kept out of this
        # module's parameters (see the module docstring)
        self._tied = (embedding_weights,)
        self.decoder_bias = nn.Parameter(torch.zeros(c.vocab_size, **kw))

    @property
    def decoder_weight(self):
        return self._tied[0]

    def forward(self, x):
        x = self.layer_norm(self.activation(self.transform(x)))
        return torch.matmul(x, self.decoder_weight.t()) + self.decoder_bias


class BertForMaskedLM(nn.Module):
    def __init__(self, config: BertConfig = None, device=None,
                 dtype=torch.float32, seed=None):
        super().__init__()
        c = config or BertConfig()
        dev = resolve_device(device)
        self.config = c
        with _init_stream(seed):
            self.bert = BertModel(c, with_pool=False, device=dev,
                                  dtype=dtype)
            self.cls = BertLMPredictionHead(
                c, self.bert.embeddings.word_embeddings.weight, dev, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        """MLM logits [B, S, vocab]; with ``labels`` [B, S] (``-100`` =
        not scored) ``(loss, logits)``, the loss
        ``nn.functional.cross_entropy``'s mean in the logits' dtype."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.cls(seq)
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                                   labels.reshape(-1), ignore_index=-100)
            return loss, logits
        return logits


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig = None, num_classes=2, device=None,
                 dtype=torch.float32, seed=None):
        super().__init__()
        c = config or BertConfig()
        dev = resolve_device(device)
        with _init_stream(seed):
            self.bert = BertModel(c, with_pool=True, device=dev, dtype=dtype)
            self.dropout = Dropout(c.hidden_dropout_prob)
            self.classifier = Linear(c.hidden_size, num_classes, device=dev,
                                     dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits
