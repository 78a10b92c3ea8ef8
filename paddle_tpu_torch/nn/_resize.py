"""``jax.image.resize``'s separable weights in NumPy, shared by
``vision.transforms.Resize`` (on the host) and ``nn.functional.interpolate``
(one matrix an axis, made once per shape on the host and applied on the
tensor's device).

``jax/_src/image/scale.py``: samples at half-pixel centres; the linear
(triangle) and cubic (Keys, a = -0.5) kernels widened by the
downscaling factor when shrinking (``antialias=True``, JAX's default),
each output's weights normalised to sum to 1; nearest takes input
``floor((j + 0.5) m / n)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def weight_mat(m, n, kernel):
    """``[m, n]`` float32 weights of output sample j over input pixel i
    (``compute_weight_mat`` at scale n / m, translation 0, antialias)."""
    f32 = np.float32
    inv_scale = 1. / (n / m)
    kernel_scale = f32(max(inv_scale, 1.))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000. * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def nearest_index(m, n):
    """The input pixel of each of ``n`` nearest samples over ``m``."""
    f32 = np.float32
    offsets = (np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n)
    return np.floor(offsets).astype(np.int64)


def align_corners_taps(m, n):
    """``_resize_align_corners``'s taps (``common.py:217-238``): output j
    at ``linspace(0, m - 1, n)[j]`` between pixels ``lo`` and ``hi =
    min(lo + 1, m - 1)`` with weight ``w`` on ``hi``."""
    pos = np.linspace(0.0, m - 1.0, n, dtype=np.float32)
    lo = np.floor(pos).astype(np.int64)
    return lo, np.minimum(lo + 1, m - 1), (pos - lo).astype(np.float32)


_KERNELS = {"linear": triangle, "cubic": keys_cubic}


@functools.lru_cache(maxsize=256)
def _on_device(kind, m, n, device, dtype):
    """The tensors of one axis's resize, made once per (shape, device,
    dtype)."""
    if kind == "nearest":
        return (torch.from_numpy(nearest_index(m, n)).to(device),)
    if kind == "corners":
        lo, hi, w = align_corners_taps(m, n)
        return (torch.from_numpy(lo).to(device),
                torch.from_numpy(hi).to(device),
                torch.from_numpy(w).to(device, dtype))
    return (torch.from_numpy(weight_mat(m, n, _KERNELS[kind])).to(
        device, dtype),)


def resize_axis(x, ax, n, kind):
    """``x`` resized to ``n`` along dim ``ax``: ``kind`` ``"nearest"``,
    ``"corners"`` (linear with aligned corners), ``"linear"`` or
    ``"cubic"`` (the weight matrix contracted in ``x``'s dtype, as
    ``jax.image.resize`` casts its weights)."""
    m = x.shape[ax]
    taps = _on_device(kind, m, n, x.device, x.dtype)
    if kind == "nearest":
        return x.index_select(ax, taps[0])
    if kind == "corners":
        lo, hi, w = taps
        shape = [1] * x.dim()
        shape[ax] = n
        w = w.reshape(shape)
        return x.index_select(ax, lo) * (1 - w) + x.index_select(ax, hi) * w
    return torch.tensordot(x, taps[0], dims=([ax], [0])).movedim(-1, ax)
