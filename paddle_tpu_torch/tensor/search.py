"""Search and sort functions, the counterparts of
``paddle_tpu/tensor/search.py`` (all 15).

Indices are int32, as JAX's with x64 off, and every tie is broken as
JAX breaks it, on the CPU and the card alike (``torch.topk`` and an
unstable ``torch.sort`` promise no order among equal values on the
card, so the sorts here are stable):

* ``topk`` is ``lax.top_k``: among equal values the lower index first
  (``[1, 3, 3, 2]``, k 2: indices ``[1, 2]``); ``largest=False`` is
  ``-top_k(-x)``;
* ``argsort(descending=True)`` flips a stable ascending sort, so equal
  values come out higher index first (``[2, 1, 3, 0]`` for ``[1, 3, 3,
  2]``); ``sort`` flips the same way;
* ``kthvalue`` takes its index from the stable ascending sort;
* ``mode`` returns the smallest most frequent value and its **count**
  (``scipy.stats.mode``'s, as JAX's; Paddle returns an index), computed
  on the host as JAX's;
* ``median`` averages the two middle values whatever ``mode`` says,
  and ``quantile``/``nanquantile`` compute ``jnp.quantile``'s five
  methods term for term;
* ``histogram`` counts in floats over ``jnp.histogram``'s edges (the
  data's range when ``min`` and ``max`` are both 0), ``histogramdd``
  runs NumPy on the host.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs

__all__ = [
    "argmax", "argmin", "argsort", "bucketize", "histogram",
    "histogramdd", "kthvalue", "median", "mode", "nanmedian",
    "nanquantile", "quantile", "searchsorted", "sort", "topk",
]


def _arg(fn, x, axis, keepdim):
    x = x.detach()
    if axis is None:
        r = fn(x.reshape(-1))
        return (r.reshape((1,) * x.dim()) if keepdim else r).to(torch.int32)
    return fn(x, axis, keepdim=keepdim).to(torch.int32)


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    """The first index of the largest value (int32 whatever ``dtype``
    says, as JAX's)."""
    return _arg(torch.argmax, x, axis, keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim)


def argsort(x, axis=-1, descending=False, stable=False):
    """The stable ascending order, flipped when ``descending``."""
    idx = torch.argsort(x.detach(), dim=axis, stable=True)
    return (idx.flip(axis) if descending else idx).to(torch.int32)


def sort(x, axis=-1, descending=False, stable=False):
    (x,) = cast_inputs("sort", x)
    s = torch.sort(x, dim=axis, stable=True).values
    return s.flip(axis) if descending else s


def topk(x, k, axis=-1, largest=True, sorted=True):
    """``lax.top_k`` along ``axis``: the k largest (or smallest) values
    and their int32 indices, the lower index first among equal
    values."""
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    (x,) = cast_inputs("topk", x)
    ax = axis % x.dim()
    a = x.movedim(ax, -1)
    key = (a if largest else -a).detach()
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    vals = torch.gather(a, -1, idx)
    return vals.movedim(-1, ax), idx.to(torch.int32).movedim(-1, ax)


def kthvalue(x, k, axis=-1, keepdim=False):
    """The k-th smallest value and its index in the stable ascending
    order."""
    s, i = torch.sort(x, dim=axis, stable=True)
    v = s.select(axis, k - 1)
    ix = i.select(axis, k - 1).to(torch.int32)
    if keepdim:
        v, ix = v.unsqueeze(axis), ix.unsqueeze(axis)
    return v, ix


def mode(x, axis=-1, keepdim=False):
    """``(values, counts)``: the smallest most frequent value along
    ``axis`` and how often it occurs (int32), on the host as JAX's."""
    a = np.moveaxis(x.detach().cpu().numpy(), axis, -1)
    lead, n = a.shape[:-1], a.shape[-1]
    rows = a.reshape(-1, n)
    s = np.sort(rows, axis=1)
    new = np.ones(s.shape, bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    run = np.cumsum(new, axis=1) - 1
    r = np.arange(s.shape[0])[:, None]
    counts = np.zeros(s.shape, np.int64)
    np.add.at(counts, (np.broadcast_to(r, run.shape), run), 1)
    best = counts.argmax(axis=1)                 # the first: smallest value
    first = (run == best[:, None]).argmax(axis=1)
    vals = s[np.arange(s.shape[0]), first].reshape(lead)
    cnts = counts[np.arange(s.shape[0]), best].reshape(lead)
    if keepdim:
        ax = axis % x.dim()
        vals, cnts = np.expand_dims(vals, ax), np.expand_dims(cnts, ax)
    return (torch.from_numpy(np.ascontiguousarray(vals)).to(x.device),
            torch.from_numpy(np.ascontiguousarray(cnts)).to(
                device=x.device, dtype=torch.int32))


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    """int32 insertion points; a batched sequence pairs each row with
    the matching row of ``values``."""
    s, v = sorted_sequence.detach(), values.detach()
    dt = torch.promote_types(s.dtype, v.dtype)
    s, v = s.to(dt), v.to(dt)
    if s.dim() == 1:
        out = torch.searchsorted(s, v, right=right)
    else:
        out = torch.searchsorted(
            s.reshape(-1, s.shape[-1]).contiguous(),
            v.reshape(-1, v.shape[-1]).contiguous(),
            right=right).reshape(v.shape)
    return out.to(torch.int32)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return searchsorted(sorted_sequence, x, out_int32, right)


def _quantile(x, q, axis, method, keepdim, squash_nans):
    """``jnp.quantile``'s arithmetic (``_quantile`` of
    ``jax._src.numpy.reductions``) over torch."""
    if method not in ("linear", "lower", "higher", "midpoint", "nearest"):
        raise ValueError("method can only be 'linear', 'lower', 'higher', "
                         "'midpoint', or 'nearest'")
    a = x if x.is_floating_point() else x.to(torch.get_default_dtype())
    qt = (q if isinstance(q, torch.Tensor) else torch.tensor(q)).to(
        device=a.device, dtype=a.dtype)
    if qt.dim() > 1:
        raise ValueError(f"q must be have rank <= 1, got shape "
                         f"{tuple(qt.shape)}")
    out_shape = None
    if axis is None:
        if keepdim:
            out_shape = [1] * a.dim()
        a, ax = a.reshape(-1), 0
    elif isinstance(axis, (list, tuple)):
        axes = sorted(d % a.dim() for d in axis)
        keep = [d for d in range(a.dim()) if d not in axes]
        out_shape = [1 if d in axes else s for d, s in enumerate(a.shape)]
        if not keepdim:
            out_shape = None
        a = a.permute(keep + axes).reshape([a.shape[d] for d in keep]
                                           + [-1])
        ax = a.dim() - 1
    else:
        ax = axis % a.dim()
    a = a.movedim(ax, -1)
    qv = qt.reshape(-1)
    if squash_nans:
        s = torch.sort(a, dim=-1, stable=True).values        # NaNs last
        counts = (~torch.isnan(s)).sum(-1, keepdim=True).to(qv.dtype)
        pos = qv * (counts - 1)
        low, high = torch.floor(pos), torch.ceil(pos)
        high_w = pos - low
        low_w = 1 - high_w
        zero = torch.zeros((), dtype=qv.dtype, device=a.device)
        low = torch.maximum(zero, torch.minimum(low, counts - 1))
        high = torch.maximum(zero, torch.minimum(high, counts - 1))
        low_v = torch.gather(s, -1, low.long())
        high_v = torch.gather(s, -1, high.long())
    else:
        n = a.shape[-1]
        a = torch.where(torch.isnan(a).any(-1, keepdim=True),
                        torch.full_like(a, _math.nan), a)
        s = torch.sort(a, dim=-1, stable=True).values
        pos = qv * (n - 1)
        low, high = torch.floor(pos), torch.ceil(pos)
        high_w = pos - low
        low_w = 1 - high_w
        low = torch.clamp(low, 0, n - 1).long()
        high = torch.clamp(high, 0, n - 1).long()
        low_v, high_v = s[..., low], s[..., high]
    if method == "linear":
        out = low_v * low_w + high_v * high_w
    elif method == "lower":
        out = low_v
    elif method == "higher":
        out = high_v
    elif method == "nearest":
        out = torch.where(high_w <= 0.5, low_v, high_v)
    else:
        out = (low_v + high_v) * 0.5
    out = out.movedim(-1, 0)                     # [nq, rest...]
    if keepdim and out_shape is None:            # an int axis
        out = out.unsqueeze(ax + 1)
    elif out_shape is not None:
        out = out.reshape([out.shape[0]] + out_shape)
    if qt.dim() == 0:
        out = out[0]
    return out.to(a.dtype)


def median(x, axis=None, keepdim=False, mode="avg"):
    """The mean of the two middle values at an even length, whatever
    ``mode`` says (JAX's ``jnp.median``)."""
    (x,) = cast_inputs("median", x)
    return _quantile(x, 0.5, axis, "midpoint", keepdim, False)


def nanmedian(x, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, "midpoint", keepdim, True)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    return _quantile(x, q, axis, interpolation, keepdim, False)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    return _quantile(x, q, axis, interpolation, keepdim, True)


def jnp_linspace(start, stop, num):
    """``jnp.linspace``'s values for tensors ``start`` and ``stop`` of
    one float dtype: ``start * (1 - t) + stop * t`` with ``t = i /
    (num - 1)``, then ``stop`` itself."""
    div = num - 1
    t = torch.arange(div, device=start.device).to(start.dtype) / div
    return torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])


def histogram(input, bins=100, min=0, max=0):
    """Float counts in ``bins`` equal bins over ``[min, max]`` (the
    data's range when both are 0; the last bin closed)."""
    a = input.detach()
    a = a if a.is_floating_point() else a.to(torch.get_default_dtype())
    if min != 0 or max != 0:
        lo = torch.tensor(min, dtype=a.dtype, device=a.device)
        hi = torch.tensor(max, dtype=a.dtype, device=a.device)
    else:
        lo, hi = a.min(), a.max()
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    edges = jnp_linspace(lo, hi, bins + 1)
    idx = torch.searchsorted(edges, a.reshape(-1), right=True)
    idx = torch.where(a.reshape(-1) == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    return counts.to(a.dtype)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None):
    """``numpy.histogramdd`` on the host: the counts and each axis's
    edges, in the default float dtype on ``x``'s device."""
    h, edges = np.histogramdd(
        x.detach().cpu().numpy(), bins=bins, range=ranges, density=density,
        weights=None if weights is None else weights.detach().cpu().numpy())
    dt = torch.get_default_dtype()
    return (torch.from_numpy(h).to(device=x.device, dtype=dt),
            [torch.from_numpy(e).to(device=x.device, dtype=dt)
             for e in edges])
