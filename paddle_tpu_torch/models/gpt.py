"""Decoder-only transformer LM (pre-norm RMSNorm, RoPE, SwiGLU, optional
GQA), the counterpart of ``paddle_tpu/models/gpt.py``.

Parameter names match the JAX model's ``state_dict()`` key for key, so
``convert.state_dict_from_jax`` maps one onto the other.  Projections are
``torch.nn.Linear`` and keep torch's ``[out, in]`` weight layout; the
conversion transposes paddle's ``[in, out]`` once, at load.

``GPTAttention`` has two forward paths:

* the paged serving path (``cache`` is a :class:`PagedKV`): rope at
  ``pos + arange(s)``, ``paged_write`` of k and v into the pool (or
  ``paged_write_quant`` into an int8 pool), then the ragged
  paged-attention kernel over the block table; the window's rows run
  zero-padded to whole tiles, and every projection of this path (and the
  engine's LM head) multiplies tile by tile (:func:`tiled_linear`), so a
  row's bits do not depend on the window.  Under the engine's
  ``weight_dtype="int8"`` each projection's weight is rebuilt from its
  int8 payload first (:func:`serving_weight`);
* the uncached full-sequence path (training, and the reference the
  serving parity checks compare with): rope at ``arange(s)``, then
  causal flash attention (``ops/flash_attention.py``: the hand-written
  forward and backward kernels on the card), as the JAX model's SDPA
  routes to its Pallas flash kernel.  Training (``model.train()``)
  drops each layer's two residual branches with
  ``hidden_dropout_prob`` (``nn.Dropout``), and with ``use_recompute``
  runs each layer under ``distributed.recompute`` (its activations
  rebuilt in the backward, the same dropout masks replayed), as
  ``paddle_tpu/models/gpt.py:229-265``.  The serving path runs no
  dropout (the engine runs the model in ``eval()``, where JAX's dropout
  is the identity).

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
from ..distributed.recompute import recompute
from ..nn import functional as port_F
from ..nn.common import Dropout
from ..ops.flash_attention import flash_attention
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.rms_norm import rms_norm
from ..ops.rope import apply_rotary_emb
from ..serving.kv_cache import PagedKV, paged_write, paged_write_quant
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
    hidden_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_recompute: bool = False
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


#: rows one serving-path product multiplies at once (see tiled_linear)
ROW_TILE = 128


def pad_rows(x):
    """``x`` [..., K] as rows [Mp, K], zero-padded to a whole number of
    ``ROW_TILE``-row tiles (a view when no row has to be added)."""
    rows = x.reshape(-1, x.shape[-1])
    if ROW_TILE and rows.shape[0] % ROW_TILE:
        rows = F.pad(rows, (0, 0, 0, ROW_TILE - rows.shape[0] % ROW_TILE))
    return rows


def tiled_linear(rows, weight):
    """``F.linear(rows, weight)`` for the paged serving path, over rows
    [Mp, in] made by :func:`pad_rows`, with each row's bits independent
    of how many rows the call has.

    cuBLAS picks its algorithm (tile shape, split-K) from the product's
    shape, so one row multiplied in a decode step (8 rows) and in a
    prefill window (thousands) can round differently: a preempted
    request's re-prefill then cannot reproduce the token it sampled in
    decode, and a prefix hit or a chunk reads keys that an uncached,
    whole prefill would not have written.  Here the rows are multiplied
    as ``ROW_TILE``-row batches of one strided-batched product over the
    same weight (batch stride 0): every call solves the same
    ``[ROW_TILE, in] x [in, out]`` problem, whatever the window.
    ``ROW_TILE = 0`` multiplies the whole window in one ``F.linear``
    (how ``chip_smoke.py``'s ``serve_rows`` measures what the tiling
    costs and what it prevents)."""
    tile = ROW_TILE
    if not tile:
        return F.linear(rows, weight)
    n = rows.shape[0] // tile
    return torch.bmm(rows.view(n, tile, -1),
                     weight.t().expand(n, -1, -1)).view(n * tile, -1)


def serving_weight(linear, wq):
    """``linear``'s weight on the serving path: with ``wq`` (the engine's
    ``{nn.Linear: QuantizedWeight}`` under ``weight_dtype="int8"``) the
    int8 weight dequantized to the model's dtype, else the weight."""
    qw = wq.get(linear) if wq else None
    return linear.weight if qw is None else qw.dequantize()


def row_linear(x, weight):
    """:func:`tiled_linear` of any ``x`` [..., in]: pad, multiply, and
    drop the padding rows again."""
    m = x.numel() // x.shape[-1]
    return tiled_linear(pad_rows(x), weight)[:m].view(*x.shape[:-1], -1)


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

    def forward(self, x):
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.kv_heads, self.head_dim)
        pos = torch.arange(s, device=x.device)
        q = apply_rotary_emb(q, pos, self.rope_theta)
        k = apply_rotary_emb(k, pos, self.rope_theta)
        out = flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))

    def forward_paged(self, rows, cache, b, s, wq=None):
        """The serving path over the padded rows [Mp, hidden] of a
        [b, s] window: row-tiled projections (:func:`tiled_linear`,
        weights from :func:`serving_weight`), rope at the per-row
        positions, k/v written into the lane's table-mapped pool blocks
        (write-before-attend, so a token sees its own key; quantized per
        token into an int8 pool), then ragged paged attention over the
        table.  Returns the padded rows of the output projection (zero in
        the padding rows) and the advanced view."""
        m = b * s
        w = lambda lin: serving_weight(lin, wq)
        q = tiled_linear(rows, w(self.q_proj))[:m].view(
            b, s, self.num_heads, self.head_dim)
        k = tiled_linear(rows, w(self.k_proj))[:m].view(
            b, s, self.kv_heads, self.head_dim)
        v = tiled_linear(rows, w(self.v_proj))[:m].view(
            b, s, self.kv_heads, self.head_dim)
        pos = cache.pos
        pos_ids = pos.long()[:, None] + torch.arange(s, device=q.device)
        q = apply_rotary_emb(q, pos_ids, self.rope_theta)
        k = apply_rotary_emb(k, pos_ids, self.rope_theta)
        if cache.k_scale is None:
            paged_write(cache.k, k, cache.tables, pos)
            paged_write(cache.v, v, cache.tables, pos)
        else:
            paged_write_quant(cache.k, cache.k_scale, k, cache.tables, pos)
            paged_write_quant(cache.v, cache.v_scale, v, cache.tables, pos)
        out = paged_attention(q.contiguous(), cache.k, cache.v,
                              cache.tables, pos, cache.k_scale,
                              cache.v_scale)
        out = tiled_linear(pad_rows(out.reshape(m, -1)), w(self.o_proj))
        return out, PagedKV(cache.k, cache.v, cache.tables, pos + s,
                            cache.k_scale, cache.v_scale)


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

    def forward_paged(self, rows, wq=None):
        """The serving path over padded rows (:func:`tiled_linear`)."""
        w = lambda lin: serving_weight(lin, wq)
        h = F.silu(tiled_linear(rows, w(self.gate_proj))) * \
            tiled_linear(rows, w(self.up_proj))
        return tiled_linear(h, w(self.down_proj))


class GPTDecoderLayer(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.rms_norm_eps
        self.input_layernorm = RMSNorm(h, eps, device, dtype)
        self.self_attn = GPTAttention(config, device, dtype)
        self.post_attention_layernorm = RMSNorm(h, eps, device, dtype)
        self.mlp = GPTMLP(config, device, dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        x = x + self.dropout(self.self_attn(self.input_layernorm(x)))
        return x + self.dropout(self.mlp(self.post_attention_layernorm(x)))

    def forward_paged(self, rows, cache, b, s, wq=None):
        """The serving path over the padded rows of a [b, s] window; the
        padding rows stay zero through every row-wise op."""
        h, new_cache = self.self_attn.forward_paged(
            self.input_layernorm(rows), cache, b, s, wq)
        rows = rows + h
        rows = rows + self.mlp.forward_paged(
            self.post_attention_layernorm(rows), wq)
        return rows, new_cache


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

    def forward(self, input_ids, caches=None, wq=None):
        """Hidden states [B, S, hidden]; with ``caches`` (one PagedKV
        per layer: the serving path) also the advanced views.  The
        serving path carries the window's rows zero-padded to whole
        ``ROW_TILE``-row tiles through every layer (:func:`pad_rows`),
        so only attention sees the [B, S] window; ``wq`` maps its int8
        weights (:func:`serving_weight`)."""
        # the port's embedding: its backward is deterministic on the card
        x = port_F.embedding(input_ids, self.embed_tokens.weight)
        if caches is None:
            remat = self.config.use_recompute and self.training
            for layer in self.layers:
                x = recompute(layer, x) if remat else layer(x)
            return self.norm(x)
        b, s = input_ids.shape
        rows = pad_rows(x)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            rows, nc = layer.forward_paged(rows, cache, b, s, wq)
            new_caches.append(nc)
        return self.norm(rows[:b * s]).view(b, s, -1), new_caches


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

    def _logits(self, h, paged=False, wq=None):
        """The LM head; ``paged`` (the serving engine) multiplies through
        :func:`row_linear`, with ``wq``'s int8 head if it has one."""
        weight = (self.lm_head.weight if self.lm_head is not None
                  else self.model.embed_tokens.weight)
        if paged:
            if self.lm_head is not None:
                weight = serving_weight(self.lm_head, wq)
            return row_linear(h, weight)
        if self.lm_head is not None:
            return self.lm_head(h)
        return h @ weight.t()

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
