"""The fused Transformer layers of ``paddle_tpu/incubate/nn/layer.py``
(Paddle's ``paddle.incubate.nn``): ``FusedMultiHeadAttention``,
``FusedFeedForward`` and ``FusedTransformerEncoderLayer``, with JAX's
parameter names, shapes (paddle's ``[in, out]`` weights; the packed qkv
weight ``[3, heads, head_dim, E]``, or ``[E, 3E]`` with
``transpose_qkv_wb``) and initializers: weights Xavier-uniform over
JAX's fans (``paddle_tpu/nn/initializer/initializer.py:19-30``), norm
scales 1, biases 0, drawn from the port's counter stream
(:mod:`paddle_tpu_torch.random`), one key a weight.  Their forwards are
the fused functionals, so the LayerNorm and flash kernels run on the
card (attention with no mask and, in training, ``attn_dropout_rate``
0)."""

from __future__ import annotations

from ...nn.initializer import Constant, XavierUniform
from ...nn.layers import Layer
from . import functional as IF


def _param(layer, shape, device, value=None):
    """A weight Xavier-uniform over JAX's fans, or a constant ``value``."""
    init = XavierUniform() if value is None else Constant(value)
    return layer.create_parameter(shape, default_initializer=init,
                                  device=device)


class FusedMultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, device=None,
                 dtype=None):
        super().__init__(dtype=dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self._epsilon = epsilon
        self._transpose_qkv_wb = transpose_qkv_wb
        qkv_shape = ((embed_dim, 3 * embed_dim) if transpose_qkv_wb else
                     (3, num_heads, self.head_dim, embed_dim))
        self.qkv_weight = _param(self, qkv_shape, device)
        self.qkv_bias = _param(self, (3 * embed_dim,), device, 0.0)
        self.linear_weight = _param(self, (embed_dim, embed_dim), device)
        self.linear_bias = _param(self, (embed_dim,), device, 0.0)
        self.pre_ln_scale = _param(self, (embed_dim,), device, 1.0)
        self.pre_ln_bias = _param(self, (embed_dim,), device, 0.0)
        self.ln_scale = _param(self, (embed_dim,), device, 1.0)
        self.ln_bias = _param(self, (embed_dim,), device, 0.0)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return IF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            qkv_bias=self.qkv_bias, linear_bias=self.linear_bias,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate, training=self.training,
            num_heads=self.num_heads,
            transpose_qkv_wb=self._transpose_qkv_wb)


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, nranks=1, ring_id=-1, device=None,
                 dtype=None):
        super().__init__(dtype=dtype)
        self._activation = activation
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._epsilon = epsilon
        self._normalize_before = normalize_before
        self.linear1_weight = _param(self, (d_model, dim_feedforward), device)
        self.linear1_bias = _param(self, (dim_feedforward,), device, 0.0)
        self.linear2_weight = _param(self, (dim_feedforward, d_model), device)
        self.linear2_bias = _param(self, (d_model,), device, 0.0)
        self.ln1_scale = _param(self, (d_model,), device, 1.0)
        self.ln1_bias = _param(self, (d_model,), device, 0.0)
        self.ln2_scale = _param(self, (d_model,), device, 1.0)
        self.ln2_bias = _param(self, (d_model,), device, 0.0)

    def forward(self, src, cache=None):
        return IF.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight, self.linear1_bias,
            self.linear2_bias, self.ln1_scale, self.ln1_bias, self.ln2_scale,
            self.ln2_bias, self._act_dropout_rate, self._dropout_rate,
            self._activation, self._epsilon, self._epsilon,
            self._normalize_before, self.training)


class FusedTransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation,
            act_dropout_rate=(dropout_rate if act_dropout_rate is None
                              else act_dropout_rate),
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
