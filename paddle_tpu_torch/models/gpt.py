"""Decoder-only transformer LM (pre-norm RMSNorm, RoPE, SwiGLU, optional
GQA), the counterpart of ``paddle_tpu/models/gpt.py``.

Parameter names match the JAX model's ``state_dict()`` key for key, so
``convert.state_dict_from_jax`` maps one onto the other.  Projections are
``torch.nn.Linear`` and keep torch's ``[out, in]`` weight layout; the
conversion transposes paddle's ``[in, out]`` once, at load.

``GPTAttention`` has two forward paths:

* the paged serving path (``cache`` is a :class:`PagedKV`): rope at
  ``pos + arange(s)``, ``paged_write`` of k and v into the pool, then
  the ragged paged-attention kernel over the block table;
* the uncached full-sequence path (training, and the reference the
  serving parity checks compare with): rope at ``arange(s)``, then
  causal flash attention (``ops/flash_attention.py``: the hand-written
  forward and backward kernels on the card), as the JAX model's SDPA
  routes to its Pallas flash kernel.

``GPTForCausalLM.forward(input_ids, labels)`` returns the mean token
cross-entropy beside the logits, or beside None with
``config.fused_lm_loss`` (the chunked fused LM-head loss, which never
materialises the ``[B*S, vocab]`` f32 logits).  The labels are used as
given, unshifted, as the JAX model does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.rms_norm import rms_norm
from ..ops.rope import apply_rotary_emb
from ..serving.kv_cache import PagedKV, paged_write
from ..serving.paged_attention import paged_attention


@dataclass
class GPTConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_key_value_heads: int = None  # GQA; defaults to MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    # fused chunked LM-head CE: never materialises [B*S, vocab] f32 logits
    # (forward(labels=...) then returns (loss, None))
    fused_lm_loss: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self):
        return self.num_key_value_heads or self.num_attention_heads


ERNIE_7B = GPTConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_hidden_layers=32, num_attention_heads=32, max_position_embeddings=4096,
)
LLAMA2_13B = GPTConfig(
    vocab_size=32000, hidden_size=5120, intermediate_size=13824,
    num_hidden_layers=40, num_attention_heads=40, max_position_embeddings=4096,
)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, eps=1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def _linear(i, o, device, dtype):
    return nn.Linear(i, o, bias=False, device=device, dtype=dtype)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.kv_heads = c.kv_heads
        self.head_dim = c.head_dim
        self.rope_theta = c.rope_theta
        self.q_proj = _linear(c.hidden_size, self.num_heads * self.head_dim,
                              device, dtype)
        self.k_proj = _linear(c.hidden_size, self.kv_heads * self.head_dim,
                              device, dtype)
        self.v_proj = _linear(c.hidden_size, self.kv_heads * self.head_dim,
                              device, dtype)
        self.o_proj = _linear(self.num_heads * self.head_dim, c.hidden_size,
                              device, dtype)

    def forward(self, x, cache=None):
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.kv_heads, self.head_dim)
        if cache is not None:
            return self._forward_paged(q, k, v, cache, b, s)
        pos = torch.arange(s, device=x.device)
        q = apply_rotary_emb(q, pos, self.rope_theta)
        k = apply_rotary_emb(k, pos, self.rope_theta)
        out = flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))

    def _forward_paged(self, q, k, v, cache, b, s):
        """Rope at the per-row positions, write k/v into the lane's
        table-mapped pool blocks (write-before-attend, so a token sees
        its own key), then ragged paged attention over the table."""
        pos = cache.pos
        pos_ids = pos.long()[:, None] + torch.arange(s, device=q.device)
        q = apply_rotary_emb(q, pos_ids, self.rope_theta)
        k = apply_rotary_emb(k, pos_ids, self.rope_theta)
        paged_write(cache.k, k, cache.tables, pos)
        paged_write(cache.v, v, cache.tables, pos)
        out = paged_attention(q.contiguous(), cache.k, cache.v,
                              cache.tables, pos)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        return out, PagedKV(cache.k, cache.v, cache.tables, pos + s)


class GPTMLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        c = config
        self.gate_proj = _linear(c.hidden_size, c.intermediate_size,
                                 device, dtype)
        self.up_proj = _linear(c.hidden_size, c.intermediate_size,
                               device, dtype)
        self.down_proj = _linear(c.intermediate_size, c.hidden_size,
                                 device, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class GPTDecoderLayer(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.rms_norm_eps
        self.input_layernorm = RMSNorm(h, eps, device, dtype)
        self.self_attn = GPTAttention(config, device, dtype)
        self.post_attention_layernorm = RMSNorm(h, eps, device, dtype)
        self.mlp = GPTMLP(config, device, dtype)

    def forward(self, x, cache=None):
        h = self.input_layernorm(x)
        if cache is not None:
            h, new_cache = self.self_attn(h, cache)
        else:
            h, new_cache = self.self_attn(h), None
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, device=device,
                                         dtype=dtype)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device, dtype)

    def forward(self, input_ids, caches=None):
        """Hidden states [B, S, hidden]; with ``caches`` (one PagedKV
        per layer) also the advanced views."""
        x = self.embed_tokens(input_ids)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            x, nc = layer(x, None if caches is None else caches[i])
            if caches is not None:
                new_caches.append(nc)
        x = self.norm(x)
        if caches is not None:
            return x, new_caches
        return x


class GPTForCausalLM(nn.Module):
    """The causal LM.  Built on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``) in ``dtype``, with weights drawn from a
    ``torch.Generator`` seeded by ``seed`` on that device: every matrix
    from N(0, initializer_range), norms at 1."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.model = GPTModel(config, dev, dtype)
        self.lm_head = (None if config.tie_word_embeddings else
                        _linear(config.hidden_size, config.vocab_size, dev,
                                dtype))
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("layernorm.weight") or \
                        name == "model.norm.weight":
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, config.initializer_range, generator=gen)

    @property
    def device(self):
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self):
        return self.model.embed_tokens.weight.dtype

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        return h @ self.model.embed_tokens.weight.t()

    def forward(self, input_ids, labels=None):
        """Full-sequence causal logits [B, S, vocab] (the uncached path);
        with ``labels`` [B, S] (``-100`` = ignored) ``(loss, logits)``, or
        ``(loss, None)`` under ``config.fused_lm_loss``.  The loss is the
        mean cross-entropy over the rows that are not ignored."""
        h = self.model(input_ids)
        if labels is not None and self.config.fused_lm_loss:
            # torch Linear weights are [vocab, hidden], as a tied embedding
            weight = (self.lm_head.weight if self.lm_head is not None
                      else self.model.embed_tokens.weight)
            loss = fused_linear_cross_entropy(
                h.reshape(-1, self.config.hidden_size), weight,
                labels.reshape(-1), ignore_index=-100, transpose_weight=True)
            return loss, None
        logits = self._logits(h)
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape(-1, self.config.vocab_size).to(torch.float32),
                labels.reshape(-1).to(torch.int64), ignore_index=-100)
            return loss, logits
        return logits
