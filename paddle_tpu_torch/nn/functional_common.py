"""The common functionals, the counterparts of
``paddle_tpu/nn/functional/common.py`` (``linear`` and ``embedding``
live in :mod:`.functional`; ``sparse_attention`` waits for ``sparse/``
and ``gather_tree`` for ``nn/decode.py``, ROADMAP.md Queue 1);
re-exported by :mod:`paddle_tpu_torch.nn.functional`.

The dropouts draw their masks from the port's counter stream
(:mod:`paddle_tpu_torch.random`), one key a training call; their bits
differ from JAX's threefry bits by design.

:func:`interpolate` computes JAX's function, ``jax.image.resize``
(``common.py:183-214``), not ``torch.nn.functional.interpolate``'s:
half-pixel centres; ``nearest`` takes input ``floor((j + 0.5) m / n)``;
``bilinear``, ``linear``, ``trilinear`` and ``area`` are the triangle
kernel and ``bicubic`` Keys' cubic (a = -0.5), both widened by the
downscaling factor when shrinking (JAX's antialias) and contracted as
one weight matrix an axis, made once per shape on the host and applied
on the tensor's device (:mod:`._resize`); ``align_corners=True`` moves
the linear modes to ``_resize_align_corners`` (``:217``), linear taps at
``linspace(0, m - 1, n)``, and leaves ``nearest`` and ``bicubic`` as
they were (JAX ignores it there).  ``align_mode`` is ignored, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from .. import random as _random
from ..amp.auto_cast import cast_inputs
from ..tensor.manipulation import to_dtype
from ._resize import resize_axis
from .functional_activation import weak


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """``common.py:24-45``.  ``axis`` (an int or a list) names the dims
    the mask varies along; it is shared along the others.
    ``"upscale_in_train"`` scales kept values by ``1/(1-p)`` in training
    and is the identity in eval; ``"downscale_in_infer"`` keeps them
    unscaled and multiplies by ``1-p`` in eval.  Each training call with
    ``p > 0`` takes one key.  The mask is a bool tensor that autograd
    saves, so the backward passes the gradient through the forward's
    mask."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    (x,) = cast_inputs("dropout", x)
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


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Whole channels dropped: one draw a (sample, channel)."""
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


def alpha_dropout(x, p=0.5, training=True):
    """SELU's dropout (``common.py:59-77``): a dropped value becomes
    ``-alpha scale``, then ``a x + b`` keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    (x,) = cast_inputs("alpha_dropout", x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * p * alpha_p
    u = torch.rand(x.shape, generator=_random.next_generator(x.device),
                   device=x.device)
    kept = torch.where(u < q, x, weak(alpha_p, x))
    return (weak(a_coef, x) * kept + weak(b_coef, x)).to(x.dtype)


def _pad_index(size, lo, hi, mode, device):
    """The source positions of a dim of ``size`` padded by (lo, hi):
    NumPy's ``reflect`` (no edge repeat), ``edge`` and ``wrap``."""
    i = np.arange(-lo, size + hi)
    if mode == "replicate":
        i = np.clip(i, 0, size - 1)
    elif mode == "circular":
        i = np.mod(i, size)
    elif size == 1:
        i = np.zeros_like(i)
    else:
        period = 2 * (size - 1)
        i = np.mod(i, period)
        i = np.where(i >= size, period - i, i)
    return torch.from_numpy(i.astype(np.int64)).to(device)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """``common.py:80-107``: ``pad`` of ``2 x.dim()`` ints is (before,
    after) of each dim in order; a shorter one pads the spatial dims from
    the innermost out (``[left, right, top, bottom, ...]``).  Modes
    ``constant`` (``value``), ``reflect``, ``replicate``, ``circular``."""
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(v) for v in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise KeyError(mode)
    (x,) = cast_inputs("pad", x)
    nd = x.dim()
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        widths = [(0, 0)] * nd
        first = 2 if data_format.startswith("NC") else 1
        dims = list(range(first, first + len(pad) // 2))
        for i, d in enumerate(reversed(dims)):
            widths[d] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        return TF.pad(x, [v for lo, hi in reversed(widths)
                          for v in (lo, hi)], value=value)
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW"):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def one_hot(x, num_classes):
    """The default float dtype's one-hot rows (an index outside ``[0,
    num_classes)`` gives a row of zeros)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == classes).to(torch.get_default_dtype())


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(x1 x2) / max(|x1| |x2|, eps)`` along ``axis``."""
    x1, x2 = cast_inputs("cosine_similarity", x1, x2)
    dot = (x1 * x2).sum(dim=axis)
    n = torch.linalg.vector_norm(x1, dim=axis) * torch.linalg.vector_norm(
        x2, dim=axis)
    return dot / n.clamp(min=eps)


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    (x,) = cast_inputs("pixel_shuffle", x)
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    (x,) = cast_inputs("pixel_unshuffle", x)
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW"):
    (x,) = cast_inputs("channel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(
            1, 2).reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4).reshape(
        n, h, w, c)


_LINEAR = ("bilinear", "linear", "trilinear", "area")


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    """The spatial dims resized to ``size`` or ``int(L * scale_factor)``
    as JAX's (see the module docstring)."""
    if mode not in _LINEAR + ("nearest", "bicubic"):
        raise KeyError(mode)
    (x,) = cast_inputs("interpolate", x)
    nsp = x.dim() - 2
    first = 2 if data_format.startswith("NC") else 1
    spatial = x.shape[first:first + nsp]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        sizes = size if isinstance(size, (list, tuple)) else [size] * nsp
        out_size = [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                    for s in sizes]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * nsp)
        out_size = [int(s * f) for s, f in zip(spatial, sf)]
    if mode == "nearest":
        kind = "nearest"
    elif mode in _LINEAR:
        kind = "corners" if align_corners else "linear"
    else:
        kind = "cubic"
    out = x
    for i, n in enumerate(out_size):
        if spatial[i] != n:
            out = resize_axis(out, first + i, n, kind)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col (``common.py:245-267``): ``[N, C kh kw, L]``, ``paddings``
    one int, (h, w), or (top, left, bottom, right)."""
    (x,) = cast_inputs("unfold", x)
    pd = _pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    x = TF.pad(x, [pd[1], pd[3], pd[0], pd[2]])
    return TF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im (``common.py:270-291``): overlapping patches summed, the
    padding (its first two values) cut away."""
    (x,) = cast_inputs("fold", x)
    pd = _pair(paddings)
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   dilation=_pair(dilations), padding=(pd[0], pd[1]),
                   stride=_pair(strides))


def label_smooth(label, prior_dist=None, epsilon=0.1):
    """``(1 - eps) label + eps / K``, or ``+ eps prior_dist``."""
    (label,) = cast_inputs("label_smooth", label)
    if prior_dist is not None:
        prior = torch.as_tensor(prior_dist, dtype=label.dtype,
                                device=label.device)
        return (1 - epsilon) * label + epsilon * prior
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def bilinear(x1, x2, weight, bias=None):
    """``x1_i W_oij x2_j + b_o`` with ``weight`` ``[out, in1, in2]``."""
    x1, x2, weight, bias = cast_inputs("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def sequence_mask(x, maxlen=None, dtype="int64"):
    """``[..., maxlen]``: 1 below each length, else 0 (``maxlen``
    defaults to the largest length, read on the host)."""
    if maxlen is None:
        maxlen = int(x.max().item()) if x.numel() else 0
    idx = torch.arange(int(maxlen), device=x.device)
    return (idx < x[..., None]).to(to_dtype(dtype))


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """``sum(|x - y + eps|^p)^(1/p)`` over the last dim."""
    x, y = cast_inputs("pairwise_distance", x, y)
    d = x - y + epsilon
    return (d.abs() ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def gather_tree(ids, parents):
    """Beam-search backtrace: ``ids``/``parents`` ``[time, batch, beam]``
    -> each final beam's tokens from the first step, walked back from
    the last step through the parents (JAX's scan, as a host loop over
    the steps)."""
    ids, parents = ids.detach(), parents.detach()
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).to(parents.dtype)
    outs = [ids[-1]]
    for t in range(ids.shape[0] - 2, -1, -1):
        beams = torch.gather(parents[t + 1], -1, beams.long())
        outs.append(torch.gather(ids[t], -1, beams.long()))
    return torch.stack(outs[::-1])


__all__ = [
    "alpha_dropout", "bilinear", "channel_shuffle", "cosine_similarity",
    "dropout", "dropout2d", "dropout3d", "fold", "gather_tree", "interpolate",
    "label_smooth", "one_hot", "pad", "pairwise_distance", "pixel_shuffle",
    "pixel_unshuffle", "sequence_mask", "unfold", "upsample", "zeropad2d",
]
