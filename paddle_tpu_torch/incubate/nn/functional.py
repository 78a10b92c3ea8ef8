"""The fused functionals of ``paddle_tpu/incubate/nn/functional.py``
(Paddle's ``paddle.incubate.nn.functional``), with the JAX package's
signatures, errors and arithmetic.

Weights are in paddle's layout, as the JAX functions take them: a
linear weight is ``[in, out]`` and multiplies as ``x @ W``.  The products
are cuBLAS (``torch.matmul`` / ``F.linear`` over the transposed view):
the JAX package computes them outside any Pallas kernel.  Where the JAX
function reaches a Pallas kernel, the port reaches its Hopper kernel:

* ``fused_multi_transformer``'s unmasked causal prefill runs the flash
  forward (``ops.flash_attention``: the kernel on CUDA tensors, its
  plain twin on CPU tensors; differentiable, so training through it runs
  the dQ and dK/dV kernels too), and its layer norms the LayerNorm
  kernel (f32 statistics; see :func:`fused_multi_transformer`);
* ``fused_rms_norm`` runs the RMSNorm kernel where
  ``ops.rms_norm.rms_norm_arrays`` routes it (1-D weight, no bias, the
  last axis);
* ``fused_layer_norm``, ``fused_multi_head_attention`` and
  ``fused_feedforward`` reach the LayerNorm and flash kernels through
  ``nn.functional`` (``layer_norm`` over one axis with 1-D affine
  parameters; ``scaled_dot_product_attention`` with no mask and no
  training dropout).

Everything else is plain torch, as JAX's is jnp: the decode attention
over the fixed-capacity cache (``_cache_attend``), the masked prefill,
rotary, ``swiglu`` and ``fused_ec_moe``.  Dropout draws from the port's
counter stream (``nn.functional.dropout``), so its masks differ from
JAX's threefry bits by design.  Every function casts its inputs under an
``amp.auto_cast`` scope with JAX's op name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import amp_dtype_for, cast_inputs
from ...nn import functional as F
from ...ops.flash_attention import flash_attention as _flash_op
from ...ops.fused_ce import fused_linear_cross_entropy as _fused_ce
from ...ops.layer_norm import layer_norm as _layer_norm_op
from ...ops.rms_norm import rms_norm_arrays
from ...ops.rope import apply_rotary_emb
from ...tensor import matmul as _matmul


def _plinear(x, weight, bias=None):
    """``x @ weight + bias`` with paddle's ``[in, out]`` weight (an
    ``amp`` ``linear`` op: JAX's ``F.linear``)."""
    return F.linear(x, weight, bias)


def _mm(x, weight, bias=None):
    """The same product inside a fused op, which casts its inputs once."""
    return TF.linear(x, weight.t(), bias)


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``functional.py:22-27``: ``weight`` ``[in, out]``, or ``[out, in]``
    with ``transpose_weight``."""
    return _plinear(x, weight.t() if transpose_weight else weight, bias)


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    out = _matmul(x, y, transpose_x=trans_x, transpose_y=trans_y)
    return getattr(F, activation)(out + bias)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False):
    out = _matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
    return out if bias is None else out + bias


def fused_bias_act(x, bias=None, dequant_scales=None, shift=None,
                   smooth=None, act_method="gelu", **kw):
    """``functional.py:46-50``: the quantization arguments are accepted
    and unused, as in JAX."""
    if bias is not None:
        x = x + bias
    return getattr(F, act_method)(x)


def fused_linear_cross_entropy(x, weight, label, ignore_index=-100,
                               transpose_weight=False, chunk_rows=2048,
                               reduction="mean"):
    """``functional.py:53-67`` over ``ops.fused_ce``: the LM-head product
    and the cross-entropy a row chunk at a time (the label is not
    differentiated)."""
    x, weight = cast_inputs("fused_linear_cross_entropy", x, weight)
    return _fused_ce(x, weight, label.detach(), ignore_index=ignore_index,
                     transpose_weight=transpose_weight,
                     chunk_rows=chunk_rows, reduction=reduction)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     residual_alpha=1.0, begin_norm_axis=1, bias=None,
                     residual=None, quant_scale=-1, **kw):
    """``functional.py:70-79``: ``x (+ bias) (+ residual * alpha)``, then
    LayerNorm over the axes from ``begin_norm_axis`` (default 1: a 3-D
    input normalizes over its last two axes, JAX's plain path; a 2-D one
    over its last, the kernel).  Returns the normalized tensor alone."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual * residual_alpha
    return F.layer_norm(x, list(x.shape[begin_norm_axis:]), norm_weight,
                        norm_bias, epsilon)


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=1, bias=None, residual=None, **kw):
    """``functional.py:82-91`` over ``ops.rms_norm.rms_norm_arrays``: the
    kernel only for a 2-D input at the default ``begin_norm_axis=1`` (or
    the last axis of any input), a 1-D weight and no ``norm_bias``."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    return rms_norm_arrays(x, norm_weight, norm_bias, epsilon,
                           begin_norm_axis)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train"):
    return F.dropout(x, p, training=training, mode=mode) + y


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """``functional.py:94-109``: each of q, k, v ``[B, S, H, D]`` (None
    stays None) through ``ops.rope.apply_rotary_emb``; ``time_major`` is
    accepted and unused, as in JAX."""
    outs = []
    for t in (q, k, v):
        if t is not None:
            (t,) = cast_inputs("fused_rope", t)
            t = apply_rotary_emb(t, sin=sin, cos=cos,
                                 position_ids=position_ids,
                                 neox=use_neox_rotary_style,
                                 base=rotary_emb_base)
        outs.append(t)
    return tuple(outs)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               transpose_qkv_wb=False):
    """``functional.py:112-155``: (pre-LN) -> packed qkv -> attention ->
    out projection -> dropout -> residual (-> LN).  ``qkv_weight`` is
    ``[3, heads, head_dim, E]``, or ``[E, 3E]`` with ``transpose_qkv_wb``
    (then ``num_heads`` names the heads).  Attention is
    ``nn.functional.scaled_dot_product_attention``: the flash kernels
    with no mask and no training dropout (``attn_dropout_rate`` defaults
    to 0.5, so pass ``training=False`` or 0 for them), JAX's plain f32
    path otherwise.  ``cache_kv`` is accepted and unused, as in JAX."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, [x.shape[-1]], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    b, s, e = x.shape
    if transpose_qkv_wb:
        n_heads, head_dim = num_heads, e // num_heads
        qkv = _plinear(x, qkv_weight, qkv_bias).reshape(b, s, 3, n_heads,
                                                        head_dim)
    else:
        n_heads, head_dim = qkv_weight.shape[1], qkv_weight.shape[2]
        xe, we = cast_inputs("einsum", x, qkv_weight)
        qkv = torch.einsum("bse,tnde->bstnd", xe, we)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias.reshape(1, 1, 3, n_heads, head_dim)
    ctx = F.scaled_dot_product_attention(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
        dropout_p=attn_dropout_rate, training=training)
    out = _plinear(ctx.reshape(b, s, n_heads * head_dim), linear_weight,
                   linear_bias)
    out = F.dropout(out, dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, [out.shape[-1]], ln_scale, ln_bias,
                           ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1):
    """``functional.py:158-179``: (pre-LN) -> linear1 -> activation ->
    dropout -> linear2 -> dropout -> residual (-> LN)."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, [x.shape[-1]], ln1_scale, ln1_bias, ln1_epsilon)
    out = getattr(F, activation)(_plinear(x, linear1_weight, linear1_bias))
    out = F.dropout(out, dropout1_rate, training=training, mode=mode)
    out = _plinear(out, linear2_weight, linear2_bias)
    out = residual + F.dropout(out, dropout2_rate, training=training,
                               mode=mode)
    if not pre_layer_norm:
        out = F.layer_norm(out, [out.shape[-1]], ln2_scale, ln2_bias,
                           ln2_epsilon)
    return out


# ------------------------------------------------ fixed-capacity KV cache
def _host_ints(t):
    """A step index or per-row lengths as Python ints.  A host tensor
    (as upstream Paddle passes ``time_step``) costs no device sync; a
    tensor on the card costs one copy to the host a call."""
    return [int(v) for v in torch.as_tensor(t).reshape(-1).tolist()]


def _cache_attend(q, cache_k, cache_v, window, valid, maskv):
    """``functional.py:182-207`` over the first ``window`` positions of a
    cache ``[b, h, max_seq, d]``: f32 scores, keys outside ``valid``
    (bool ``[b, 1, 1, window]``; None: all) at -1e30, the additive mask
    (raised to 4-D, zero-padded or cut to the window) added, an f32
    softmax, f32 output ``[b, s, h, d]``.  JAX attends over all
    ``max_seq`` positions with those beyond the step index at -1e30:
    their probabilities are exact zeros, so reading only the window is the
    same function, and it keeps the f32 copies of the rest of the cache
    off the bus."""
    kf = cache_k[:, :, :window].to(torch.float32)
    vf = cache_v[:, :, :window].to(torch.float32)
    qf = q.transpose(1, 2).to(torch.float32)                 # [b, h, s, d]
    scores = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if valid is not None:
        scores = torch.where(valid, scores, -1e30)
    if maskv is not None:
        m = maskv
        while m.dim() < 4:
            m = m[:, None] if m.dim() > 1 else m[None]
        if m.shape[-1] < window:
            m = TF.pad(m, (0, window - m.shape[-1]))
        scores = scores + m[..., :window]
    return torch.matmul(torch.softmax(scores, dim=-1), vf).transpose(1, 2)


def _rope_full_table(x, cos, sin, neox):
    """``functional.py:210-226``: rotate x ``[..., d]`` by full-head-dim
    tables broadcastable to it, in f32 (NeoX halves or GPT-J pairs)."""
    xf = x.to(torch.float32)
    d = x.shape[-1]
    if neox:
        rot = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    else:
        rot = torch.stack([-xf[..., 1::2], xf[..., 0::2]],
                          dim=-1).reshape(xf.shape)
    return (xf * cos.to(torch.float32)
            + rot * sin.to(torch.float32)).to(x.dtype)


def _rope_tables_at(rt, positions, head_dim):
    """``functional.py:229-249``: per-row (cos, sin) ``[b, 1, d]`` from a
    packed table ``[2, b, 1, S, d]`` (or ``[2, b, S, d]``) at each row's
    position (a tensor ``[b]``, or one int for every row), or at its one
    position when S is 1."""
    if rt.dim() == 5:
        rt = rt[:, :, 0]
    if rt.shape[-1] != head_dim:
        raise ValueError(
            f"rotary table last dim {rt.shape[-1]} != head_dim {head_dim} "
            "(tables must be FULL head_dim cos/sin)")
    if rt.shape[2] == 1:
        cs = rt[:, :, 0]
    elif isinstance(positions, int):
        cs = rt[:, :, positions]
    else:
        b = positions.shape[0]
        rt = rt.expand(2, b, rt.shape[2], head_dim)
        cs = rt[:, torch.arange(b, device=rt.device),
                positions.to(device=rt.device, dtype=torch.long)]
    return cs[0][:, None, :], cs[1][:, None, :]


def masked_multihead_attention(x, cache_kv=None, src_mask=None, bias=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, qkv_out_scale=None,
                               out_shift=None, out_smooth=None, seq_len=1,
                               rotary_emb_dims=0, use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """``functional.py:250-346``: one decode step of attention over a
    fixed-capacity cache.

    x ``[b, 3 * heads * head_dim]`` (one token's packed q, k, v);
    ``cache_kv`` ``[2, b, heads, max_seq, head_dim]``; each row's step
    index is ``sequence_lengths[b]`` (tokens already cached; default 0);
    ``src_mask`` an additive mask broadcastable to ``[b, 1, 1, max_seq]``;
    ``rotary_tensor`` packed full-head-dim ``[2, b, 1, max_seq, head_dim]``
    cos/sin tables read at each row's step (``rotary_emb_dims`` 1; GPT-J
    pairs unless ``use_neox_rotary_style``).  The new k and v are written
    into ``cache_kv`` in place, one position a row (upstream Paddle's
    contract; JAX returns a new array with the same values), and the
    attention reads the first ``max(sequence_lengths) + 1`` positions.
    The lengths are read on the host (for the full-cache check): one copy
    from the card a call when they lie there.  The quantization
    arguments are accepted and unused, as in JAX.
    Returns ``(out [b, heads * head_dim], cache_kv)``."""
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    if rotary_emb_dims not in (0, 1):
        raise NotImplementedError(
            "masked_multihead_attention: rotary_emb_dims must be 0 or 1 "
            "(2-section rope not supported)")
    if bias is not None or beam_cache_offset is not None:
        raise NotImplementedError(
            "masked_multihead_attention: bias/beam_cache_offset")
    x, src_mask, rotary_tensor = cast_inputs(
        "masked_multihead_attention", x, src_mask, rotary_tensor)
    n_head, max_seq, head_dim = cache_kv.shape[2:5]
    b = x.shape[0]
    if sequence_lengths is None:
        lens_host = [0] * b
        lens = torch.zeros(b, dtype=torch.long, device=x.device)
    else:
        lens_host = _host_ints(sequence_lengths)
        lens = torch.as_tensor(sequence_lengths).reshape(-1).to(
            device=x.device, dtype=torch.long)
    if max(lens_host) >= max_seq:
        raise ValueError(f"masked_multihead_attention: cache full "
                         f"(sequence_lengths >= max_seq {max_seq})")
    qkv = x.reshape(b, 3, n_head, head_dim)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]            # [b, h, d]
    if rotary_tensor is not None:
        cos, sin = _rope_tables_at(rotary_tensor, lens, head_dim)
        q = _rope_full_table(q, cos, sin, use_neox_rotary_style)
        k = _rope_full_table(k, cos, sin, use_neox_rotary_style)
    rows = torch.arange(b, device=x.device)
    cache_kv[:, rows, :, lens] = torch.stack([k, v], dim=1).to(
        cache_kv.dtype)
    window = max(lens_host) + 1
    valid = (torch.arange(window, device=x.device)[None, :]
             <= lens[:, None])[:, None, None, :]
    out = _cache_attend(q[:, None], cache_kv[0], cache_kv[1], window, valid,
                        src_mask)
    return out.to(x.dtype).reshape(b, n_head * head_dim), cache_kv


_FMT_ACTS = {"gelu": lambda a: TF.gelu(a, approximate="none"),
             "relu": torch.relu, "silu": TF.silu}


def _at(lst, i):
    return None if lst is None else lst[i]


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, pre_caches=None,
                            rotary_embs=None, time_step=None, attn_mask=None,
                            dropout_rate=0.0, activation="gelu",
                            training=False, mode="upscale_in_train",
                            trans_qkvw=True, ring_id=-1,
                            rotary_emb_dims=0, use_neox_rotary_style=False):
    """``functional.py:349-585``: a stack of decoder layers, each (pre-LN)
    -> packed qkv -> attention -> out projection -> residual -> (LN) ->
    FFN (gelu, relu or silu) -> residual (-> LN), with dropout
    ``dropout_rate`` at both residual adds.

    x ``[b, s, dim]``; ``qkv_weights[i]`` ``[3, heads, head_dim, dim]``
    (``trans_qkvw``) or ``[dim, 3, heads, head_dim]``; the linear and FFN
    weights ``[in, out]``; ``cache_kvs[i]`` ``[2, b, heads, max_seq,
    head_dim]``; ``rotary_embs`` packed full-head-dim cos/sin
    ``[2, b, 1, max_seq, head_dim]`` applied to q and k in every layer (at
    ``[0, s)`` in prefill, at ``time_step`` in decode).

    Attention: with ``cache_kvs`` and ``time_step``, one decode step: k
    and v written at ``time_step`` (a window of s at ``min(time_step,
    max_seq - s)``, as JAX's clamped update), then the plain f32
    ``_cache_attend`` over the cache's first ``time_step + 1`` positions
    only (the positions JAX leaves valid; the rest would add exact zeros).
    Otherwise a causal prefill, writing k and v at ``[0, s)`` when
    ``cache_kvs`` is given: with ``attn_mask``, JAX's dense f32 scores;
    without, the flash forward kernel (on CUDA tensors; its plain twin on
    CPU tensors).  The caches are written in place (upstream Paddle's
    contract) and returned.

    ``time_step`` is read on the host: a host tensor (as upstream Paddle
    passes it) costs nothing, one on the card one copy to the host a
    call; a full cache (``time_step >= max_seq``) raises.

    The layer norms run the LayerNorm kernel (``ops.layer_norm``, f32
    statistics) where JAX's jnp norm works in the input's dtype: equal
    in f32 to rounding, a few ulps apart in bf16.  Differentiable: the
    flash and LayerNorm kernels carry their backward.
    Returns out, or ``(out, cache_kvs)`` when ``cache_kvs`` is given."""
    if pre_caches is not None:
        raise NotImplementedError("fused_multi_transformer: pre_caches")
    if rotary_emb_dims not in (0, 1):
        raise NotImplementedError(
            "fused_multi_transformer: rotary_emb_dims must be 0 or 1")
    n_layers = len(qkv_weights)
    decode = cache_kvs is not None and time_step is not None
    caches = list(cache_kvs) if cache_kvs is not None else []
    if amp_dtype_for("fused_multi_transformer") is not None:
        x, attn_mask, rotary_embs = cast_inputs(
            "fused_multi_transformer", x, attn_mask, rotary_embs)
        (ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
         linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
         ffn1_biases, ffn2_weights, ffn2_biases) = (
            None if lst is None else
            list(cast_inputs("fused_multi_transformer", *lst))
            for lst in (ln_scales, ln_biases, qkv_weights, qkv_biases,
                        linear_weights, linear_biases, ffn_ln_scales,
                        ffn_ln_biases, ffn1_weights, ffn1_biases,
                        ffn2_weights, ffn2_biases))
    ts = None
    if decode:
        (ts,) = _host_ints(time_step)
        if caches and ts >= caches[0].shape[3]:
            raise ValueError(f"fused_multi_transformer: cache full "
                             f"(time_step {ts} >= max_seq "
                             f"{caches[0].shape[3]})")
    act = _FMT_ACTS[activation]
    b, s, dim = x.shape
    qw0 = qkv_weights[0]
    n_head, head_dim = ((qw0.shape[1], qw0.shape[2]) if trans_qkvw
                        else (qw0.shape[2], qw0.shape[3]))
    cos = sin = None
    if rotary_embs is not None:
        rot = rotary_embs[:, :, 0] if rotary_embs.dim() == 5 else rotary_embs
        if decode:
            cos, sin = _rope_tables_at(rot, ts, head_dim)
            cos, sin = cos[:, None], sin[:, None]          # [b, 1, 1, d]
        else:
            if rot.shape[2] < s:
                raise ValueError(
                    f"fused_multi_transformer: rotary table covers "
                    f"{rot.shape[2]} positions < prefill length {s} (a "
                    "seq-1 decode table would silently broadcast position "
                    "0 over every token)")
            cos, sin = rot[0][:, :s, None, :], rot[1][:, :s, None, :]

    def drop(t):
        if not dropout_rate:
            return t
        return F.dropout(t, dropout_rate, training=training, mode=mode)

    def norm(t, w, bias_):
        return _layer_norm_op(t, w, bias_, epsilon)

    h = x
    for i in range(n_layers):
        residual = h
        ln_in = norm(h, ln_scales[i], ln_biases[i]) if pre_layer_norm else h
        qw, qb = qkv_weights[i], _at(qkv_biases, i)
        qb = None if qb is None else qb.reshape(-1)
        qkv = (TF.linear(ln_in, qw.reshape(-1, dim), qb) if trans_qkvw
               else _mm(ln_in, qw.reshape(dim, -1), qb))
        qkv = qkv.reshape(b, s, 3, n_head, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [b, s, h, d]
        kv = qkv[:, :, 1:]                                  # [b, s, 2, h, d]
        if cos is not None:
            q = _rope_full_table(q, cos, sin, use_neox_rotary_style)
            k = _rope_full_table(k, cos, sin, use_neox_rotary_style)
            kv = torch.stack([k, v], dim=2)
        if caches:
            cache = caches[i]
            max_seq = cache.shape[3]
            if s > max_seq:
                raise ValueError(f"fused_multi_transformer: {s} tokens > "
                                 f"cache capacity {max_seq}")
            start = min(ts, max_seq - s) if decode else 0
            cache[:, :, :, start:start + s] = kv.permute(2, 0, 3, 1, 4)
        if decode:
            attn = _cache_attend(q, caches[i][0], caches[i][1], ts + 1,
                                 None, attn_mask).to(
                h.dtype, memory_format=torch.contiguous_format)
        elif attn_mask is not None:
            scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                                  k.to(torch.float32)) / math.sqrt(head_dim)
            causal = torch.ones((s, s), dtype=torch.bool,
                                device=h.device).tril()
            scores = torch.where(causal, scores, -1e30) + attn_mask[..., :s]
            attn = torch.einsum("bhst,bthd->bshd",
                                torch.softmax(scores, dim=-1),
                                v.to(torch.float32)).to(h.dtype)
        else:
            attn = _flash_op(q, k, v, causal=True)
        out = _mm(attn.reshape(b, s, n_head * head_dim), linear_weights[i],
                  _at(linear_biases, i))
        h = residual + drop(out)
        if not pre_layer_norm:
            h = norm(h, ln_scales[i], ln_biases[i])
        residual = h
        ffn_in = (norm(h, ffn_ln_scales[i], ffn_ln_biases[i])
                  if pre_layer_norm else h)
        f1 = _mm(ffn_in, ffn1_weights[i], _at(ffn1_biases, i))
        f2 = _mm(act(f1), ffn2_weights[i], _at(ffn2_biases, i))
        h = residual + drop(f2)
        if not pre_layer_norm:
            h = norm(h, ffn_ln_scales[i], ffn_ln_biases[i])
    if cache_kvs is not None:
        return h, caches
    return h


def swiglu(x, y=None):
    """``silu(x) * y``; with ``y`` None, x's last axis split in half."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    x, y = cast_inputs("swiglu", x, y)
    return TF.silu(x) * y


_MOE_ACTS = {"gelu": lambda a: TF.gelu(a, approximate="tanh"),
             "relu": torch.relu, "silu": TF.silu}


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu"):
    """``functional.py:606-630``: every token through every expert's FFN,
    weighted by ``softmax(gate)``.  x ``[b, s, d]``, gate ``[b, s, e]``,
    ``bmm0_weight`` ``[e, d, f]``, ``bmm1_weight`` ``[e, f, d]``, the
    biases ``[e, 1, f]`` / ``[e, 1, d]``.  ``"gelu"`` is the tanh form
    (``jax.nn.gelu``'s default, which the JAX function calls)."""
    if act_type not in _MOE_ACTS:
        raise ValueError(
            f"fused_ec_moe: unsupported act_type {act_type!r} "
            "(expected 'gelu', 'relu' or 'silu')")
    x, gate, w0, b0, w1, b1 = cast_inputs(
        "fused_ec_moe", x, gate, bmm0_weight, bmm0_bias, bmm1_weight,
        bmm1_bias)
    b0 = b0.reshape(b0.shape[0], b0.shape[-1])
    b1 = b1.reshape(b1.shape[0], b1.shape[-1])
    probs = torch.softmax(gate, dim=-1)
    h = _MOE_ACTS[act_type](torch.einsum("bsd,edf->bsef", x, w0) + b0)
    o = torch.einsum("bsef,efd->bsed", h, w1) + b1
    return torch.einsum("bsed,bse->bsd", o, probs)
