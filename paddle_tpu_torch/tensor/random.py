"""Random functions, the counterparts of ``paddle_tpu/tensor/random.py``
(all 17), on the port's counter stream (:mod:`paddle_tpu_torch.random`).

Each draw takes one key of the stream and a ``torch.Generator`` seeded
from it on the device it fills, so a draw depends only on the seed and
the number of keys taken before it; the bits differ from JAX's threefry
bits by design (tests hold the draws to their shapes, dtypes, ranges and
moments).  ``uniform(seed=s)`` with ``s != 0`` draws from the fixed key
``(s, 0)`` and leaves the stream alone, as JAX's ``PRNGKey(s)``; the
in-place ``uniform_`` ignores its ``seed``, as JAX's.  The functions that
make a tensor from a shape take ``device=`` and draw on the card unless
asked for the CPU; the ``*_like`` ones and those of tensors draw where
their tensor lies.  Integer draws are int32 whatever ``"int64"`` says
(x64 off); ``multinomial`` returns int32 indices.
"""

from __future__ import annotations

import torch

from .. import random as _random
from ..device import resolve_device
from .creation import jax_dtype, shape_of

__all__ = [
    "bernoulli", "bernoulli_", "exponential_", "gumbel_softmax",
    "multinomial", "normal", "normal_", "poisson", "rand", "rand_like",
    "randint", "randint_like", "randn", "randn_like", "randperm",
    "standard_normal", "uniform", "uniform_",
]


def _gen(device):
    return _random.next_generator(device)


def rand(shape, dtype=None, device=None):
    dev = resolve_device(device)
    return torch.rand(shape_of(shape), dtype=jax_dtype(dtype), device=dev,
                      generator=_gen(dev))


def randn(shape, dtype=None, device=None):
    dev = resolve_device(device)
    return torch.randn(shape_of(shape), dtype=jax_dtype(dtype), device=dev,
                       generator=_gen(dev))


def standard_normal(shape, dtype=None, device=None):
    return randn(shape, dtype, device)


def normal(mean=0.0, std=1.0, shape=None, device=None):
    """N(0, 1) draws times ``std`` plus ``mean``: of the broadcast shape
    of tensor arguments (on their device), else of ``shape``."""
    tensors = [t for t in (mean, std) if isinstance(t, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        shp = torch.broadcast_shapes(*(t.shape for t in tensors))
    else:
        dev = resolve_device(device)
        shp = shape_of(shape) if shape is not None else ()
    z = torch.randn(shp, device=dev, generator=_gen(dev))
    return z * std + mean


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, device=None):
    """Uniform on ``[min, max)``; ``seed != 0`` draws from the key
    ``(seed, 0)`` and leaves the stream alone."""
    dev = resolve_device(device)
    g = (_random.generator((seed, 0), dev) if seed else _gen(dev))
    out = torch.empty(shape_of(shape), dtype=jax_dtype(dtype), device=dev)
    return out.uniform_(min, max, generator=g)


def uniform_(x, min=-1.0, max=1.0, seed=0):
    """``x`` refilled in place from the stream (``seed`` ignored, as
    JAX's)."""
    with torch.no_grad():
        return x.uniform_(min, max, generator=_gen(x.device))


def randint(low=0, high=None, shape=(1,), dtype="int64", device=None):
    """Integers on ``[low, high)`` (``[0, low)`` without ``high``)."""
    if high is None:
        low, high = 0, low
    dev = resolve_device(device)
    return torch.randint(int(low), int(high), shape_of(shape), device=dev,
                         generator=_gen(dev)).to(jax_dtype(dtype))


def randint_like(x, low=0, high=None, dtype=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), x.shape, device=x.device,
                         generator=_gen(x.device)).to(
        jax_dtype(dtype, x.dtype))


def randperm(n, dtype="int64", device=None):
    dev = resolve_device(device)
    return torch.randperm(int(n), device=dev, generator=_gen(dev)).to(
        jax_dtype(dtype))


def multinomial(x, num_samples=1, replacement=False):
    """int32 category draws from each row of probabilities ``x``
    (normalised; without replacement each row's draws differ)."""
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(x.device)).to(torch.int32)


def bernoulli(x):
    """1 with probability ``x``, else 0, in ``x``'s dtype."""
    return torch.bernoulli(x.detach(), generator=_gen(x.device))


def bernoulli_(x, p=0.5):
    with torch.no_grad():
        return x.bernoulli_(p, generator=_gen(x.device))


def poisson(x):
    return torch.poisson(x.detach(), generator=_gen(x.device))


def exponential_(x, lam=1.0):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))


def normal_(x, mean=0.0, std=1.0):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))


def rand_like(x, dtype=None):
    return torch.rand(x.shape, dtype=jax_dtype(dtype, x.dtype),
                      device=x.device, generator=_gen(x.device))


def randn_like(x, dtype=None):
    return torch.randn(x.shape, dtype=jax_dtype(dtype, x.dtype),
                       device=x.device, generator=_gen(x.device))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    from ..nn.functional_activation import gumbel_softmax as _gs

    return _gs(x, temperature, hard, axis)
