"""Functionals of the port's model slices, the counterparts of
``paddle_tpu/nn/functional/norm.py``, ``attention.py``, ``common.py``
(``linear``, ``embedding``), ``conv.py`` and ``pooling.py``; the
activations (:mod:`.functional_activation`), the rest of ``common.py``
(:mod:`.functional_common`), ``vision.py`` (:mod:`.functional_vision`)
and the losses (:mod:`.functional_loss`) live beside it and are
re-exported here.  The max pools return JAX's mask with
``return_mask`` (the flat position of each window's first maximum in
its (N, C) plane) and ``max_unpool1d/2d/3d`` put values back at it.

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
  computes that path in jnp, outside any Pallas kernel.  The public
  :func:`flash_attention` and :func:`flash_attn_unpadded` (one segment
  at a time) route the same way.
* :func:`rms_norm` is JAX's plain jnp RMSNorm (``norm.py:186-206``): no
  kernel there, none here (``incubate.nn.functional.fused_rms_norm`` is
  the kernel's entry).

:func:`linear` takes paddle's ``[in, out]`` weight, as JAX's.  The
attention dropout draws its masks from the port's counter stream
(:mod:`paddle_tpu_torch.random`), one key a call.

Convolution, pooling, BatchNorm and InstanceNorm are plain torch, as the
JAX package leaves them to ``lax.conv_general_dilated``,
``lax.reduce_window`` and jnp outside any Pallas kernel: cuDNN's
convolutions and pools on the card.  Each takes every padding form of
JAX's ``_norm_padding`` and gives JAX's windows: asymmetric (lo, hi)
padding and the lax ``"SAME"`` rule (torch's ``"same"`` refuses a
stride) are padded explicitly.  Channels-last layouts (``NLC``,
``NHWC``, ``NDHWC``) keep the OIHW weight and hand cuDNN the NC* view of
the channels-last memory, its native NHWC path.  BatchNorm copies
JAX's arithmetic (``torch.batch_norm`` rounds in another order and
takes torch's momentum).

Every function the JAX package names as an op asks
:func:`paddle_tpu_torch.amp.auto_cast.cast_inputs` for its inputs' dtype
under an ``amp.auto_cast`` scope, with JAX's op name.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np

import torch
import torch.nn.functional as TF

from .. import random as _random
from ..amp.auto_cast import cast_inputs
from ..ops.flash_attention import flash_attention as _flash_op
from ..ops.group_norm import group_norm as _group_norm_op
from ..ops.layer_norm import layer_norm as _layer_norm_op
from ..ops.rms_norm import rms_norm_axes_plain as rms_norm  # noqa: F401
from .functional_activation import *  # noqa: F401,F403
from .functional_activation import weak as _weak
from .functional_common import *  # noqa: F401,F403
from .functional_loss import *  # noqa: F401,F403  (the loss functionals)
from .functional_vision import *  # noqa: F401,F403


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
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
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
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
    """``x @ weight + bias`` with ``weight`` ``[in, out]``, paddle's
    layout (``paddle_tpu/nn/functional/common.py:16-21``): cuBLAS's GEMM
    over the transposed view, with the other transpose flag, no copy."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    return TF.linear(x, weight.t(), bias)


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` [num, dim] at the ids ``x``; with
    ``padding_idx`` those positions give 0 (and no gradient), as
    ``common.py:110-121``; ``sparse`` is accepted and ignored, as JAX's
    (the gradient is dense).  An indexing gather: its backward sums the rows
    of a repeated id in a fixed order (a sorted, accumulating
    ``index_put_``), where ``torch.nn.functional.embedding``'s CUDA
    backward gave another gradient from run to run for ids repeated
    thousands of times (BERT's two token types, H100)."""
    (weight,) = cast_inputs("embedding", weight)
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


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
    query, key, value = cast_inputs("scaled_dot_product_attention", query,
                                    key, value)
    drop = dropout_p > 0.0 and training
    if attn_mask is None and not drop:
        return _flash_op(query, key, value, causal=is_causal)
    gen = _random.next_generator(query.device) if drop else None
    return sdpa_plain(query, key, value, attn_mask,
                      dropout_p if drop else 0.0, is_causal,
                      generator=gen)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True):
    """``attention.py:94-101``: :func:`scaled_dot_product_attention`
    with no mask -> ``(out, None)`` (no softmax is ever returned)."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, training=True):
    """``attention.py:104-126``: packed sequences ``[total, H, D]`` cut at
    the cumulative lengths (read on the host: one copy from the card per
    tensor there), each attended alone as a batch of one, the outputs
    concatenated -> ``(out, None)``.  Without training dropout each
    segment runs the flash kernels, with it the plain f32 path, as
    :func:`scaled_dot_product_attention` routes.  ``scale`` multiplies
    the scores (default ``1/sqrt(D)``); JAX's version drops it (ROADMAP.md
    Queue 3)."""
    cq = [int(v) for v in torch.as_tensor(cu_seqlens_q).tolist()]
    ck = [int(v) for v in torch.as_tensor(cu_seqlens_k).tolist()]
    query, key, value = cast_inputs("scaled_dot_product_attention", query,
                                    key, value)
    drop = dropout > 0.0 and training
    outs = []
    for i in range(len(cq) - 1):
        q = query[cq[i]:cq[i + 1]].unsqueeze(0)
        k = key[ck[i]:ck[i + 1]].unsqueeze(0)
        v = value[ck[i]:ck[i + 1]].unsqueeze(0)
        if drop:
            o = sdpa_plain(q, k, v, None, dropout, causal, scale,
                           generator=_random.next_generator(q.device))
        else:
            o = _flash_op(q, k, v, causal=causal, scale=scale)
        outs.append(o.squeeze(0))
    return torch.cat(outs, dim=0), None


def sdp_kernel(*args, **kwargs):
    """``attention.py:129-131``: a context that selects nothing (the
    routing above is fixed)."""
    return contextlib.nullcontext()


# ------------------------------------------------------------ convolution
_CHANNELS_LAST = ("NLC", "NWC", "NHWC", "NDHWC")
_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _ntuple(v, n):
    """An int, or a list of 1 or ``n`` ints, as ``n`` ints."""
    if isinstance(v, (list, tuple)):
        out = [int(x) for x in v]
        return tuple(out * n if len(out) == 1 else out)
    return (int(v),) * n


def _norm_padding(padding, n):
    """``"SAME"`` / ``"VALID"``, or ``(lo, hi)`` for each of the ``n``
    spatial dims from: an int; ``n`` ints; ``2n`` ints, (lo, hi) of each
    dim in turn; or (lo, hi) pairs of which the last ``n`` are the
    spatial dims (the NCHW-style ``[[0, 0], [0, 0], [1, 1], [2, 2]]``).
    JAX's ``_norm_padding`` (``conv.py:25-39``) reads the pairs only
    where their count is neither ``n`` nor ``2n``."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (list, tuple)):
        flat = list(padding)
        if flat and all(isinstance(p, (list, tuple)) for p in flat):
            return [(int(lo), int(hi)) for lo, hi in flat[-n:]]
        if len(flat) == n:
            return [(int(p), int(p)) for p in flat]
        if len(flat) == 2 * n:
            return [(int(flat[2 * i]), int(flat[2 * i + 1]))
                    for i in range(n)]
    return [(int(padding), int(padding))] * n


def _same_pads(spatial, window, stride):
    """lax's ``"SAME"``: ``ceil(L / s)`` windows and the padding they
    need, the odd element at the end."""
    pads = []
    for size, k, s in zip(spatial, window, stride):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_arg(pads):
    """``TF.pad``'s argument for (lo, hi) of each spatial dim."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format, op):
    """``conv.py:50-81``: ``weight`` ``[O, I/groups, *k]``."""
    x, weight, bias = cast_inputs(op, x, weight, bias)
    channels_last = data_format in _CHANNELS_LAST
    if channels_last:
        x = x.movedim(-1, 1)
    stride, dilation = _ntuple(stride, n), _ntuple(dilation, n)
    pads = _norm_padding(padding, n)
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        window = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
        pads = _same_pads(x.shape[2:], window, stride)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        x, pad = TF.pad(x, _pad_arg(pads)), 0
    out = _CONV[n](x, weight, bias, stride, pad, dilation, groups)
    return out.movedim(1, -1) if channels_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format, output_size, op):
    """``conv.py:97-173``: ``weight`` ``[I, O/groups, *k]``.  With (lo,
    hi) padding the output is the unpadded transposed convolution,
    ``(L - 1) s + d (k - 1) + 1`` long, less ``lo`` at the start and
    ``hi - output_padding`` at the end (zeros where that is negative),
    then the bias; ``"SAME"`` pads ``max(d (k - 1) + 1 - s, 0)`` in all.
    ``output_size`` (which JAX ignores) sets ``output_padding`` to reach
    it."""
    x, weight, bias = cast_inputs(op, x, weight, bias)
    channels_last = data_format in _CHANNELS_LAST
    if channels_last:
        x = x.movedim(-1, 1)
    stride, dilation = _ntuple(stride, n), _ntuple(dilation, n)
    window = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
    pads = _norm_padding(padding, n)
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        pads = [(t // 2, t - t // 2) for t in
                (max(w - s, 0) for w, s in zip(window, stride))]
    opad = _ntuple(output_padding, n) if output_padding else (0,) * n
    if output_size is not None:
        opad = [o - ((size - 1) * s + w - lo - hi) for o, size, s, w, (lo, hi)
                in zip(_ntuple(output_size, n)[-n:], x.shape[2:], stride,
                       window, pads)]
    out = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
    edges = [(-lo, op_ - hi) for (lo, hi), op_ in zip(pads, opad)]
    if any(e != (0, 0) for e in edges):
        out = TF.pad(out, _pad_arg(edges))
    if bias is not None:
        out = out + bias.reshape((-1,) + (1,) * n)
    return out.movedim(1, -1) if channels_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format, output_size,
                           "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size,
                           "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size,
                           "conv3d_transpose")


# ---------------------------------------------------------------- pooling
_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG_POOL = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _window_sum(x, kernel, stride):
    if len(kernel) == 1:
        return TF.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                             divisor_override=1).squeeze(-2)
    return _AVG_POOL[len(kernel)](x, kernel, stride, divisor_override=1)


def _pool(x, kernel, stride, padding, n, data_format, op, ceil_mode=False,
          average=False, exclusive=True):
    """``pooling.py:14-72``.  With (lo, hi) padding there are
    ``floor((L + lo + hi - k) / s) + 1`` windows, or with ``ceil_mode``
    ``ceil(...) + 1`` less one where the last would start in the right
    padding; the right padding is cut or extended to what they need.
    Max pools pad with -inf.  An exclusive average divides by the real
    elements of its window where there is padding; any other by
    ``prod(kernel)``, even over the ceil-mode overhang.  ``"SAME"`` and
    ``"VALID"`` are lax's (never exclusive).  Where the padding is even
    and at most half the window, torch's pool pads in place."""
    (x,) = cast_inputs(op, x)
    channels_last = data_format in _CHANNELS_LAST
    if channels_last:
        x = x.movedim(-1, 1)
    kernel = _ntuple(kernel, n)
    stride = _ntuple(stride if stride is not None else kernel, n)
    pads = _norm_padding(padding, n)
    spatial = tuple(x.shape[2:])
    sizes = None
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        pads = _same_pads(spatial, kernel, stride)
    else:
        sizes, need = [], []
        for size, k, s, (lo, hi) in zip(spatial, kernel, stride, pads):
            num = size + lo + hi - k
            o = -(-num // s) + 1 if ceil_mode else num // s + 1
            if ceil_mode and (o - 1) * s >= size + lo:
                o -= 1
            sizes.append(o)
            need.append((lo, max(0, (o - 1) * s + k - size - lo)))
        pads = need
    counts = (average and exclusive and sizes is not None
              and any(p != (0, 0) for p in pads))
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, kernel)):
        pad = tuple(lo for lo, _ in pads)
        out = (_AVG_POOL[n](x, kernel, stride, pad,
                            count_include_pad=not counts) if average
               else _MAX_POOL[n](x, kernel, stride, pad))
    elif average:
        divisor = math.prod(kernel)
        if counts:
            ones = torch.ones((1, 1) + spatial, dtype=x.dtype,
                              device=x.device)
            divisor = _window_sum(TF.pad(ones, _pad_arg(pads)), kernel,
                                  stride)
        out = _window_sum(TF.pad(x, _pad_arg(pads)), kernel,
                          stride) / divisor
    else:
        out = _MAX_POOL[n](TF.pad(x, _pad_arg(pads), value=-math.inf),
                           kernel, stride)
    for i, o in enumerate(sizes or ()):
        if out.shape[2 + i] != o:
            out = out.narrow(2 + i, 0, o)
    return out.movedim(1, -1) if channels_last else out


@functools.lru_cache(maxsize=64)
def _mask_windows(spatial, out_sp, kernel, stride, pad_lo):
    """NumPy ``[L * K]`` flat input positions of each output's window
    (clipped into the plane) and whether each lies inside it, window by
    window in row-major order (``pooling.py:186-213``)."""
    n = len(spatial)
    flat = valid = None
    for d in range(n):
        c = (np.arange(out_sp[d])[:, None] * stride[d] - pad_lo[d]
             + np.arange(kernel[d])[None, :])
        shape = [1] * (2 * n)
        shape[d], shape[n + d] = out_sp[d], kernel[d]
        c = c.reshape(shape)
        v = (c >= 0) & (c < spatial[d])
        cc = np.clip(c, 0, spatial[d] - 1)
        valid = v if valid is None else valid & v
        flat = cc if flat is None else flat * spatial[d] + cc
    full = tuple(out_sp) + tuple(kernel)
    return (np.broadcast_to(flat, full).reshape(-1).astype(np.int64),
            np.broadcast_to(valid, full).reshape(-1).copy())


def _max_pool_with_mask(x, kernel, stride, padding, n, channel_last,
                        ceil_mode):
    """``pooling.py:164-236``: the pooled output and the mask, the flat
    position of each window's maximum in its (N, C) plane (int32); the
    first maximum in the window's row-major order wins a tie, padding
    never does, and the windows are ``_pool``'s (``ceil_mode`` too).
    String padding raises, as JAX's."""
    (x,) = cast_inputs(f"max_pool{n}d_mask", x)
    kernel = _ntuple(kernel, n)
    stride = _ntuple(stride if stride is not None else kernel, n)
    pads = _norm_padding(padding, n)
    if isinstance(pads, str):
        raise NotImplementedError("return_mask with string padding")
    if channel_last:
        x = x.movedim(-1, 1)
    spatial = tuple(x.shape[2:])
    out_sp = []
    for size, k, s, (lo, hi) in zip(spatial, kernel, stride, pads):
        num = size + lo + hi - k
        o = -(-num // s) + 1 if ceil_mode else num // s + 1
        if ceil_mode and (o - 1) * s >= size + lo:
            o -= 1
        out_sp.append(o)
    out_sp = tuple(out_sp)
    flat_np, valid_np = _mask_windows(spatial, out_sp, kernel, stride,
                                      tuple(lo for lo, _ in pads))
    flat = torch.from_numpy(flat_np).to(x.device)
    valid = torch.from_numpy(valid_np).to(x.device)
    nb, c = x.shape[:2]
    big_l, big_k = math.prod(out_sp), math.prod(kernel)
    windows = torch.where(valid, x.reshape(nb, c, -1)[:, :, flat],
                          -math.inf).reshape(nb, c, big_l, big_k)
    arg = windows.argmax(-1, keepdim=True)
    out = windows.gather(-1, arg).reshape((nb, c) + out_sp)
    mask = flat.reshape(big_l, big_k).expand(nb, c, big_l, big_k).gather(
        -1, arg).reshape((nb, c) + out_sp).int()
    if channel_last:
        out, mask = out.movedim(1, -1), mask.movedim(1, -1)
    return out, mask


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL"):
    """With ``return_mask``, ``(out, mask)`` (:func:`_max_pool_with_mask`)."""
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 1,
                                   data_format in ("NLC", "NWC"), ceil_mode)
    return _pool(x, kernel_size, stride, padding, 1, data_format,
                 "max_pool1d", ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 2,
                                   data_format == "NHWC", ceil_mode)
    return _pool(x, kernel_size, stride, padding, 2, data_format,
                 "max_pool2d", ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW"):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 3,
                                   data_format == "NDHWC", ceil_mode)
    return _pool(x, kernel_size, stride, padding, 3, data_format,
                 "max_pool3d", ceil_mode)


def _max_unpool(x, indices, kernel, stride, padding, n, output_size,
                channel_last):
    """``pooling.py:239-283``: each value of ``x`` written at its mask
    position of an (N, C) plane of zeros, the plane ``output_size[-n:]``
    or ``(L - 1) s - 2 pad + k`` a dim; a position outside the plane is
    dropped, and of values written to one position the last lands, as
    JAX's scatter does (its gradient goes to that value alone)."""
    kernel = _ntuple(kernel, n)
    stride = _ntuple(stride if stride is not None else kernel, n)
    pads = _norm_padding(padding, n)
    pad_lo = ((0,) * n if isinstance(pads, str)
              else tuple(lo for lo, _ in pads))
    (x,) = cast_inputs(f"max_unpool{n}d", x)
    if channel_last:
        x, indices = x.movedim(-1, 1), indices.movedim(-1, 1)
    in_sp = x.shape[2:]
    if output_size is not None:
        out_sp = tuple(int(s) for s in list(output_size)[-n:])
    else:
        out_sp = tuple((in_sp[i] - 1) * stride[i] - 2 * pad_lo[i] + kernel[i]
                       for i in range(n))
    nb, c = x.shape[:2]
    size = math.prod(out_sp)
    idx = indices.reshape(nb * c, -1).long()
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    # one write a position, the last, as JAX's scatter: so the gradient
    # reaches the value that landed once (overlapping windows repeat a
    # position), where torch's would reach every write
    pos = torch.arange(idx.shape[1], device=x.device).expand_as(idx)
    last = torch.full((nb * c, size + 1), -1, dtype=torch.long,
                      device=x.device).scatter_reduce(1, idx, pos, "amax")
    idx = torch.where(last.gather(1, idx) == pos, idx, size)
    out = torch.zeros((nb * c, size + 1), dtype=x.dtype,
                      device=x.device).scatter(1, idx, x.reshape(nb * c, -1))
    out = out[:, :size].reshape((nb, c) + out_sp)
    return out.movedim(1, -1) if channel_last else out


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 1,
                       output_size, data_format == "NLC")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 2,
                       output_size, data_format == "NHWC")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 3,
                       output_size, data_format == "NDHWC")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _pool(x, kernel_size, stride, padding, 1, data_format,
                 "avg_pool1d", ceil_mode, True, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, 2, data_format,
                 "avg_pool2d", ceil_mode, True, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _pool(x, kernel_size, stride, padding, 3, data_format,
                 "avg_pool3d", ceil_mode, True, exclusive)


def _adaptive_pool(x, output_size, n, data_format, mode):
    """``pooling.py:112-134``, one spatial dim at a time: output ``j`` of
    ``o`` over ``L`` reduces ``[floor(j L / o), ceil((j + 1) L / o))``
    (a mean, or a max whose gradient splits among ties).  Slices and
    means, so the backward is deterministic on the card (the CUDA
    backward of ``F.adaptive_avg_pool2d`` is not)."""
    (x,) = cast_inputs(f"adaptive_{mode}_pool{n}d", x)
    first = 1 if data_format in _CHANNELS_LAST else 2
    sizes = (list(output_size) if isinstance(output_size, (list, tuple))
             else [output_size] * n)
    out = x
    for i, o in enumerate(sizes):
        ax, size = first + i, out.shape[first + i]
        if o is None or o == size:
            continue
        segs = []
        for j in range(o):
            lo, hi = j * size // o, -(-(j + 1) * size // o)
            seg = out.narrow(ax, lo, hi - lo)
            segs.append(seg.mean(ax, keepdim=True) if mode == "avg"
                        else seg.amax(ax, keepdim=True))
        out = segs[0] if len(segs) == 1 else torch.cat(segs, ax)
    return out


def adaptive_avg_pool1d(x, output_size):
    return _adaptive_pool(x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_pool(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False):
    """``return_mask`` is accepted and ignored, as JAX's
    (``pooling.py:152-155``; ROADMAP.md Queue 3)."""
    return _adaptive_pool(x, output_size, 1, "NCL", "max")


def adaptive_max_pool2d(x, output_size, return_mask=False):
    return _adaptive_pool(x, output_size, 2, "NCHW", "max")


def adaptive_max_pool3d(x, output_size, return_mask=False):
    return _adaptive_pool(x, output_size, 3, "NCDHW", "max")


# ----------------------------------------------------- batch / instance norm
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """``norm.py:50-110`` term for term.  In training (unless
    ``use_global_stats``) the batch's mean and population variance over
    every dim but the channel's (f32 sums rounded to the input's dtype,
    as ``jnp.mean``/``jnp.var``), then ``(x - mean) * rsqrt(var + eps)
    * weight + bias`` in the input's dtype; the running buffers update
    in place with Paddle's momentum, ``running * momentum + batch * (1 -
    momentum)``, the variance unbiased by ``n / (n - 1)``.  Otherwise the
    running buffers normalise.  Python constants round to the dtype of
    the tensor they meet first, as JAX's weak types."""
    channel = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != channel)
    shape = [1] * x.dim()
    shape[channel] = -1
    if training and not use_global_stats:
        x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
        var, mean = torch.var_mean(x, axes, correction=0)
        out = (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + _weak(epsilon, var))
        if running_mean is not None:
            n = math.prod([x.shape[i] for i in axes])
            with torch.no_grad():
                unbiased = var * _weak(n / max(n - 1, 1), var)
                running_mean.copy_(running_mean * _weak(momentum, running_mean)
                                   + mean * _weak(1 - momentum, mean))
                running_var.copy_(running_var * _weak(momentum, running_var)
                                  + unbiased * _weak(1 - momentum, unbiased))
    else:
        x, mean, var, weight, bias = cast_inputs(
            "batch_norm", x, running_mean, running_var, weight, bias)
        out = (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + _weak(epsilon, var))
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    """``norm.py:160-183``: each sample's channels normalised over their
    spatial dims (population variance); the running buffers are not
    used, as in JAX."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    first = data_format.startswith("NC")
    axes = tuple(range(2, x.dim())) if first else tuple(range(1, x.dim() - 1))
    var, mean = torch.var_mean(x, axes, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + _weak(eps, var))
    shape = [1] * x.dim()
    shape[1 if first else -1] = -1
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """``x / max(|x|_p, epsilon)``, the vector p-norm along ``axis``
    (``norm.py:210-215``)."""
    (x,) = cast_inputs("normalize", x)
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / n.clamp(min=epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """``x / (k + alpha s / size)^beta``, ``s`` the sum of squares over
    the channels ``[c - (size - size // 2 - 1), c + size // 2]`` that
    exist (``norm.py:218-235``)."""
    (x,) = cast_inputs("local_response_norm", x)
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    half = size // 2
    sq = x.square().movedim(ch, -1)
    sq = TF.pad(sq, (size - half - 1, half))
    acc = sq.unfold(-1, size, 1).sum(-1).movedim(-1, ch)
    return x / torch.pow(k + alpha * acc / size, beta)
