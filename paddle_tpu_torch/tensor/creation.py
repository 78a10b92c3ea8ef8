"""Creation functions, the counterparts of ``paddle_tpu/tensor/creation.py``
(all 24 of ``paddle_tpu/tensor/__init__.py:11-16``).

A function that makes a tensor from nothing (``zeros``, ``full``,
``arange``, ``eye``, ``tril_indices``, ...) takes ``device=`` and builds
on the CUDA card unless the caller passes ``device="cpu"``
(:func:`paddle_tpu_torch.resolve_device`: no card, no default); the
``*_like`` functions and those of tensors run where their tensors lie.

JAX's dtype rules with x64 off: with no ``dtype`` a bool fill is bool,
an int fill (and ``arange`` over ints) int32, anything else the default
float dtype (``dtype.get_default_dtype``); an integer dtype asked for
as ``"int64"`` comes back int32 (``tril_indices``' default), as JAX's
does.  ``diag_embed`` keeps JAX's
``[..., n, n + |offset|]`` result (``dim1``/``dim2`` ignored; a
negative offset's rows past ``n`` dropped), where Paddle's is square.
No creation function is an op JAX names, so none casts under AMP.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..device import resolve_device
from ..dtype import get_default_dtype
from .manipulation import to_dtype

__all__ = [
    "arange", "assign", "clone", "complex", "diag", "diag_embed",
    "diagflat", "empty", "empty_like", "eye", "full", "full_like",
    "linspace", "logspace", "meshgrid", "one_hot", "ones", "ones_like",
    "polar", "tril", "tril_indices", "triu", "triu_indices", "zeros",
    "zeros_like",
]


def jax_dtype(dtype, default=None):
    """A torch dtype for ``dtype`` by JAX's x64-off rule (int64 ->
    int32); ``default`` (else the default float dtype) for None."""
    if dtype is None:
        return default if default is not None else get_default_dtype()
    dt = to_dtype(dtype)
    return torch.int32 if dt == torch.int64 else dt


def as_int32(t):
    """``t`` with an int64 dtype made int32 (JAX's integers with x64
    off); other dtypes unchanged."""
    return t.to(torch.int32) if t.dtype == torch.int64 else t


def shape_of(shape):
    """A tuple of ints from an int, a sequence or a tensor."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def zeros(shape, dtype=None, device=None):
    return torch.zeros(shape_of(shape), dtype=jax_dtype(dtype),
                       device=resolve_device(device))


def ones(shape, dtype=None, device=None):
    return torch.ones(shape_of(shape), dtype=jax_dtype(dtype),
                      device=resolve_device(device))


def _fill_dtype(fill_value, dtype):
    if dtype is not None:
        return jax_dtype(dtype)
    if isinstance(fill_value, bool):
        return torch.bool
    if isinstance(fill_value, (int, np.integer)):
        return torch.int32
    return get_default_dtype()


def full(shape, fill_value, dtype=None, device=None):
    """A bool fill is bool, an int fill int32, else the default float
    dtype, unless ``dtype`` says otherwise."""
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return torch.full(shape_of(shape), fill_value,
                      dtype=_fill_dtype(fill_value, dtype),
                      device=resolve_device(device))


def empty(shape, dtype=None, device=None):
    """Zeros, as JAX's (a buffer has no uninitialised state there)."""
    return zeros(shape, dtype, device)


def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=jax_dtype(dtype, x.dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=jax_dtype(dtype, x.dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=jax_dtype(dtype, x.dtype))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, device=None):
    """int32 when every bound is an int, else the default float dtype;
    ``arange(n)`` counts from 0."""
    for v in (start, end, step):
        if isinstance(v, torch.Tensor):
            raise TypeError("arange bounds must be python scalars")
    if dtype is None:
        ints = builtins.all(isinstance(v, (int, np.integer, type(None)))
                            for v in (start, end, step))
        dt = torch.int32 if ints else get_default_dtype()
    else:
        dt = jax_dtype(dtype)
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=dt,
                        device=resolve_device(device))


def _linspace(start, stop, num, dtype, device):
    from .search import jnp_linspace

    dt = jax_dtype(dtype)
    comp = dt if dt.is_floating_point else get_default_dtype()
    dev = resolve_device(device)
    lo = torch.tensor(start, dtype=comp, device=dev)
    hi = torch.tensor(stop, dtype=comp, device=dev)
    num = int(num)
    out = (jnp_linspace(lo, hi, num) if num > 1 else lo.reshape(1)[:num])
    return out, dt


def linspace(start, stop, num, dtype=None, device=None):
    """``jnp.linspace``'s values (``start * (1 - t) + stop * t``)."""
    out, dt = _linspace(start, stop, num, dtype, device)
    return (out if dt.is_floating_point else torch.floor(out)).to(dt)


def logspace(start, stop, num, base=10.0, dtype=None, device=None):
    """``base ** linspace(start, stop, num)``."""
    out, dt = _linspace(start, stop, num, dtype, device)
    return torch.pow(base, out).to(dt)


def eye(num_rows, num_columns=None, dtype=None, device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=jax_dtype(dtype),
                     device=resolve_device(device))


def meshgrid(*args, **kwargs):
    """``ij``-indexed grids of 1-D tensors (given apart or as one
    list)."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*args, indexing="ij"))


def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def diag(x, offset=0, padding_value=0):
    """A 1-D ``x`` on the ``offset`` diagonal of a square matrix whose
    other entries are ``padding_value``; the ``offset`` diagonal of a
    2-D ``x``."""
    if x.dim() == 1 and padding_value != 0:
        # JAX's terms: padding + (diagflat(x) - diagflat(padding))
        n = x.shape[0] + builtins.abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        return base + (torch.diagflat(x, offset) - torch.diagflat(
            torch.full_like(x, padding_value), offset))
    return torch.diag(x, offset)


def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """``[..., n] -> [..., n, n + |offset|]``, ``x`` on the ``offset``
    diagonal (JAX's shape; ``dim1``/``dim2`` are ignored, as there)."""
    n = x.shape[-1]
    out = torch.zeros(x.shape + (n + builtins.abs(offset),), dtype=x.dtype,
                      device=x.device)
    idx = torch.arange(n, device=x.device)
    if offset >= 0:
        out[..., idx, idx + offset] = x
    else:
        keep = idx - offset < n          # JAX drops the rows past n
        out[..., idx[keep] - offset, idx[keep]] = x[..., keep]
    return out


def assign(x, output=None):
    """A copy of ``x`` (``x + 0``); with ``output``, written into it."""
    out = x + 0
    if output is not None:
        output.data = out.detach()
        return output
    return out


def clone(x):
    return x.clone()


def one_hot(x, num_classes):
    from ..nn.functional_common import one_hot as _one_hot

    return _one_hot(x, num_classes)


def complex(real, imag):
    """``real + 1j * imag``."""
    dt = torch.promote_types(torch.promote_types(real.dtype, imag.dtype),
                             get_default_dtype())
    return torch.complex(real.to(dt), imag.to(dt))


def polar(abs_, angle):
    """``abs_ * exp(1j * angle)``."""
    return torch.polar(abs_, angle)


def tril_indices(row, col=None, offset=0, dtype="int64", device=None):
    """``[2, n]`` row and column indices of the lower triangle, row by
    row."""
    col = row if col is None else col
    return torch.tril_indices(int(row), int(col), offset,
                              device=resolve_device(device)).to(
        jax_dtype(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64", device=None):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), offset,
                              device=resolve_device(device)).to(
        jax_dtype(dtype))
