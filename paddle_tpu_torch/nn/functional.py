"""Functionals of the port's model slices, the counterparts of
``paddle_tpu/nn/functional/norm.py``, ``attention.py``, ``common.py``,
``activation.py`` and ``loss.py``.

Routing follows the JAX package with the card in the TPU's place:

* :func:`layer_norm` over the last dim with 1-D weight and bias goes to
  ``ops.layer_norm`` (the CUDA kernels on CUDA tensors, their plain
  twins on CPU tensors), as ``norm.py:16-47`` routes to the Pallas kernel;
  any other form is plain torch, as JAX's jnp path.
* :func:`group_norm` over NC* with 1-D weight and bias goes to
  ``ops.group_norm``, as ``norm.py:113-125`` routes to the Pallas kernel
  (whose extra ``group_norm_supported`` guard is the TPU's VMEM budget;
  the card's kernel raises on a shape it does not take, it never falls
  back); any other form, and channels-last (NHWC), is plain torch
  written here (the JAX package is jnp there too).
* :func:`scaled_dot_product_attention` over ``[B, S, H, D]`` with no mask
  and no training dropout goes to ``ops.flash_attention`` at every query
  length (JAX's ``q_len >= 128`` threshold at ``attention.py:55-66`` is a
  TPU tiling rule), which computes ``_sdpa_ref``'s function, rows with
  no visible key included.  With a mask or training dropout it runs
  :func:`sdpa_plain`, JAX's ``_sdpa_ref`` term for term in f32: JAX
  computes that path in jnp, outside any Pallas kernel.

:func:`linear` takes the port's ``[out, in]`` weight (torch's layout;
``convert`` transposes paddle's ``[in, out]`` once, at load).
:func:`dropout` and the attention dropout draw their masks from the
port's counter stream (:mod:`paddle_tpu_torch.random`), one key a call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .. import random as _random
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


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with ``weight`` ``[out, in]``."""
    return TF.linear(x, weight, bias)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """``paddle_tpu/nn/functional/common.py:24-45``.  ``axis`` (an int or
    a list) names the dims the mask varies along; it is shared along
    the others.  ``"upscale_in_train"`` scales kept values by
    ``1/(1-p)`` in training and is the identity in eval;
    ``"downscale_in_infer"`` keeps them unscaled and multiplies by
    ``1-p`` in eval.  Each training call with ``p > 0`` takes one key.
    The mask is a bool tensor that autograd saves, so the backward
    passes the gradient through the forward's mask."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    u = torch.rand(shape, generator=_random.next_generator(x.device),
                   device=x.device)
    keep = u < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def embedding(x, weight, padding_idx=None):
    """Rows of ``weight`` [num, dim] at the ids ``x``; with
    ``padding_idx`` those positions give 0 (and no gradient), as
    ``common.py:110-121``.  An indexing gather: its backward sums the rows
    of a repeated id in a fixed order (a sorted, accumulating
    ``index_put_``), where ``torch.nn.functional.embedding``'s CUDA
    backward gave another gradient from run to run for ids repeated
    thousands of times (BERT's two token types, H100)."""
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def gelu(x, approximate=False):
    """Exact (erf) GELU, or the tanh approximation with ``approximate``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def sdpa_plain(q, k, v, mask=None, dropout_p=0.0, causal=False,
               scale=None, generator=None):
    """``_sdpa_ref`` (``paddle_tpu/nn/functional/attention.py:22-50``)
    term for term over ``[B, S, H, D]``: f32 scores; ``causal`` and a bool
    ``mask`` set hidden scores to -1e30, any other mask is added; rows
    with no visible key give 0; with ``dropout_p`` and a ``generator``
    the probabilities are dropped and scaled by ``1/(1-p)``; the output
    in q's dtype.  Differentiable by torch autograd, which keeps the
    ``[B, H, Sq, Sk]`` f32 probabilities (twice with dropout) and a bool
    mask or two of that shape for the backward."""
    if k.shape[2] != q.shape[2]:
        if q.shape[2] % k.shape[2]:
            raise ValueError(f"GQA needs q heads {q.shape[2]} divisible by "
                             f"kv heads {k.shape[2]}")
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * s
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=q.device).tril(sk - sq)
        logits = torch.where(cm, logits, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, -1e30)
        else:
            logits = logits + mask.to(logits.dtype)
    p = torch.softmax(logits, dim=-1)
    row_has_key = (logits > -1e29).any(dim=-1, keepdim=True)
    p = torch.where(row_has_key, p, 0.0)
    if dropout_p > 0.0 and generator is not None:
        u = torch.rand(p.shape, generator=generator, device=p.device)
        p = torch.where(u < 1.0 - dropout_p, p / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhst,bthd->bshd", p, v.to(torch.float32))
    return out.to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Inputs ``[batch, seq, num_heads, head_dim]`` (paddle's layout).
    No mask and no training dropout: the flash kernels.  Otherwise
    :func:`sdpa_plain`, drawing one key of the port's stream when it
    drops (``attention.py:77-91``)."""
    drop = dropout_p > 0.0 and training
    if attn_mask is None and not drop:
        return flash_attention(query, key, value, causal=is_causal)
    gen = _random.next_generator(query.device) if drop else None
    return sdpa_plain(query, key, value, attn_mask,
                      dropout_p if drop else 0.0, is_causal,
                      generator=gen)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """``paddle_tpu/nn/functional/loss.py:26-63`` term for term, in the
    logits' dtype (as JAX's ``log_softmax``): integer labels (``axis``
    is the class dim; ``ignore_index`` rows count for nothing), per-class
    ``weight``, ``label_smoothing``, or soft labels of the logits' shape.
    ``"mean"`` over integer labels divides by ``max(valid rows, 1)``, or
    with ``weight`` by ``max(sum of the valid rows' weights, 1e-12)``;
    soft labels take the plain mean."""
    logits = input
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, min=1e-30))
    n_class = logits.shape[axis]
    if soft_label or (label.dim() == logits.dim()
                      and label.shape == logits.shape):
        soft = label
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_class
        loss = -(soft * logp).sum(dim=axis)
    else:
        lbl = label.long()
        if lbl.dim() == logits.dim():
            lbl = lbl.squeeze(axis)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0)
        if label_smoothing > 0:
            oh = TF.one_hot(safe, n_class).to(logp.dtype).movedim(-1, axis)
            oh = oh * (1 - label_smoothing) + label_smoothing / n_class
            nll = -(oh * logp).sum(dim=axis)
        else:
            nll = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(
                axis)
        if weight is not None:
            cw = weight[safe]
            nll = nll * cw
            if reduction == "mean":
                denom = torch.where(valid, cw, 0.0).sum()
                return torch.where(valid, nll, 0.0).sum() / torch.clamp(
                    denom, min=1e-12)
        loss = torch.where(valid, nll, 0.0)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.to(logp.dtype).sum(),
                                            min=1.0)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def mse_loss(input, label):
    """The mean of ``square(input - label)`` in the input's dtype, as
    ``paddle_tpu/nn/functional/loss.py:102`` with its default
    ``reduction="mean"``."""
    return (input - label).square().mean()
