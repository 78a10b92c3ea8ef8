"""Functionals of the port's model slices, the counterparts of
``paddle_tpu/nn/functional/norm.py``, ``attention.py`` and ``loss.py``.

Routing follows the JAX package with the card in the TPU's place:

* :func:`layer_norm` over the last dim with 1-D weight and bias goes to
  ``ops.layer_norm`` (the Triton kernels on CUDA tensors, their plain
  twins on CPU tensors), as ``norm.py:16-47`` routes to the Pallas kernel;
  any other form is plain torch, as JAX's jnp path.
* :func:`group_norm` over NC* with 1-D weight and bias goes to
  ``ops.group_norm``, as ``norm.py:113-125`` routes to the Pallas kernel
  (whose extra ``group_norm_supported`` guard is the TPU's VMEM budget;
  the card's kernel raises on a shape it does not take, it never falls
  back); any other form, and channels-last (NHWC), is plain torch
  written here (the JAX package is jnp there too).
* :func:`scaled_dot_product_attention` over ``[B, S, H, D]`` goes to
  ``ops.flash_attention`` at every query length (JAX's ``q_len >= 128``
  threshold at ``attention.py:55-66`` is a TPU tiling rule), which
  computes ``_sdpa_ref``'s function, rows with no visible key included.
  An attention mask and dropout have no caller in the port yet and
  raise.
"""

from __future__ import annotations

import torch

from ..ops.flash_attention import flash_attention
from ..ops.group_norm import group_norm as _group_norm_op
from ..ops.layer_norm import layer_norm as _layer_norm_op


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(list(normalized_shape))
    if (n_axes == 1 and weight is not None and bias is not None
            and weight.dim() == 1 and bias.dim() == 1):
        return _layer_norm_op(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW"):
    channels_first = data_format.startswith("NC")
    if (channels_first and weight is not None and bias is not None
            and weight.dim() == 1 and bias.dim() == 1):
        return _group_norm_op(x, weight, bias, num_groups, epsilon)
    if channels_first:
        n, c = x.shape[0], x.shape[1]
        spatial = tuple(x.shape[2:])
        g = x.reshape((n, num_groups, c // num_groups) + spatial)
        axes = tuple(range(2, g.dim()))
        shape = (1, c) + (1,) * len(spatial)
    else:
        n, c = x.shape[0], x.shape[-1]
        spatial = tuple(x.shape[1:-1])
        g = x.reshape((n,) + spatial + (num_groups, c // num_groups))
        axes = tuple(range(1, g.dim() - 2)) + (g.dim() - 1,)
        shape = (1,) * (len(spatial) + 1) + (c,)
    mean = g.mean(axes, keepdim=True)
    var = g.var(axes, unbiased=False, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Inputs ``[batch, seq, num_heads, head_dim]`` (paddle's layout)."""
    if attn_mask is not None or (dropout_p > 0.0 and training):
        raise NotImplementedError("attention masks and dropout are not "
                                  "ported")
    return flash_attention(query, key, value, causal=is_causal)


def mse_loss(input, label):
    """The mean of ``square(input - label)`` in the input's dtype, as
    ``paddle_tpu/nn/functional/loss.py:102`` with its default
    ``reduction="mean"``."""
    return (input - label).square().mean()
