"""``paddle.incubate.autograd``, the counterpart of
``paddle_tpu/incubate/autograd.py``: ``jvp``/``vjp`` and the
``Jacobian``/``Hessian`` objects over ``paddle_tpu_torch.autograd``.

As JAX's, the objects cover one input tensor and one output, with full
NumPy-style slicing of the matrix; several inputs, a func with several
outputs and ``is_batched=True`` raise ``NotImplementedError`` pointing
at ``paddle.autograd.jacobian``/``hessian``, which return the full
block structures.
"""

from __future__ import annotations

import torch

from ..autograd import _inputs
from ..autograd import hessian as _hessian_fn
from ..autograd import jacobian as _jacobian_fn
from ..autograd import jvp, vjp  # noqa: F401  (re-exports)

__all__ = ["jvp", "vjp", "Jacobian", "Hessian", "jacobian", "hessian"]

jacobian = _jacobian_fn
hessian = _hessian_fn


def _reject(kind, cond, what):
    if cond:
        raise NotImplementedError(
            f"{kind}: {what} is not supported by this lite object; use "
            "paddle.autograd.jacobian/hessian for the full block "
            "structure")


class Jacobian:
    """``J = Jacobian(func, x)``; ``J[...]`` slices the jacobian (one
    input tensor, one output tensor)."""

    def __init__(self, func, xs, is_batched=False):
        _reject("Jacobian", is_batched, "is_batched=True")
        _reject("Jacobian", isinstance(xs, (list, tuple)),
                "multiple xs tensors")
        # reject a multi-output func before paying for the jacobian
        _, (x,) = _inputs(xs)
        with torch.no_grad():
            out = func(x)
        _reject("Jacobian", isinstance(out, (tuple, list)),
                "a multi-output func")
        self._mat = _jacobian_fn(func, xs)

    @property
    def shape(self):
        return self._mat.shape

    def __getitem__(self, idx):
        return self._mat[idx]


class Hessian:
    """The hessian of a scalar ``func`` of one input tensor, sliced as
    a matrix."""

    def __init__(self, func, xs, is_batched=False):
        _reject("Hessian", is_batched, "is_batched=True")
        _reject("Hessian", isinstance(xs, (list, tuple)),
                "multiple xs tensors")
        self._mat = _hessian_fn(func, xs)

    @property
    def shape(self):
        return self._mat.shape

    def __getitem__(self, idx):
        return self._mat[idx]
