"""The Transformer encoder, the counterpart of
``paddle_tpu/nn/layer/transformer.py:23-186``: ``MultiHeadAttention``,
``TransformerEncoderLayer`` (post-norm, or pre-norm with
``normalize_before``) and ``TransformerEncoder``.

Parameter names match the JAX layers' ``state_dict()`` keys.  Self-
attention with ``kdim == vdim == embed_dim`` multiplies q, k and v as
one product over the three weights concatenated along the output rows
(``[3E, E]`` in the port's ``[out, in]`` layout; JAX concatenates its
``[in, out]`` weights along axis 1, the same columns), as JAX does by
default; autograd splits the gradient back through the concatenation.
Attention goes through ``nn.functional.scaled_dot_product_attention``:
the flash kernels with no mask and no training dropout, the plain f32
path otherwise.

The incremental-decoding cache (``gen_cache``) and the decoder half
(``TransformerDecoderLayer``, ``Transformer``) are not ported.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from . import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, bias_attr=None, device=None,
                 dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(bias_attr=bias_attr, device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim, embed_dim, **kw)
        self.v_proj = Linear(vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)
        self._fuse_qkv = kdim == embed_dim and vdim == embed_dim

    def _split_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = query if value is None else value
        if self._fuse_qkv and key is query and value is query:
            w = torch.cat([self.q_proj.weight, self.k_proj.weight,
                           self.v_proj.weight], dim=0)          # [3E, E]
            bias = None
            if self.q_proj.bias is not None:
                bias = torch.cat([self.q_proj.bias, self.k_proj.bias,
                                  self.v_proj.bias], dim=0)
            qkv = F.linear(query, w, bias)
            b, s = qkv.shape[0], qkv.shape[1]
            qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self._split_heads(self.q_proj(query))
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if self.need_weights:
            return out, None
        return out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, bias_attr=None, layer_norm_eps=1e-5,
                 device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (deep copies: equal
    initial values, separate parameters), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        output = src
        for layer in self.layers:
            output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output
