"""Comparison, logical and bitwise functions, the counterparts of
``paddle_tpu/tensor/logic.py`` (all 21).

Each runs where its tensors lie and returns no gradient (JAX detaches
the inputs); the second operand may be a Python number.  ``is_empty``
is a 0-d bool tensor on ``x``'s device, ``is_tensor`` asks for a
``torch.Tensor``, and ``in_dynamic_mode`` is True (the port has no
static mode).  The shifts are arithmetic, as ``jnp``'s, whatever
``is_arithmetic`` says.
"""

from __future__ import annotations

import sys

import torch

__all__ = [
    "all", "any", "bitwise_and", "bitwise_left_shift", "bitwise_not",
    "bitwise_or", "bitwise_right_shift", "bitwise_xor", "equal",
    "greater_equal", "greater_than", "in_dynamic_mode", "is_empty",
    "is_tensor", "less_equal", "less_than", "logical_and", "logical_not",
    "logical_or", "logical_xor", "not_equal",
]


def _cmp(fn, x, y):
    x = x.detach()
    return fn(x, y.detach() if isinstance(y, torch.Tensor) else y)


def _tensor(fn):
    """``fn`` that takes only tensors, with a number turned into one of
    ``x``'s dtype."""
    def f(x, y):
        if not isinstance(y, torch.Tensor):
            y = torch.tensor(y, device=x.device).to(torch.promote_types(
                x.dtype, torch.tensor(y).dtype))
        return fn(x, y)
    return f


def equal(x, y):
    return _cmp(torch.eq, x, y)


def not_equal(x, y):
    return _cmp(torch.ne, x, y)


def greater_than(x, y):
    return _cmp(torch.gt, x, y)


def greater_equal(x, y):
    return _cmp(torch.ge, x, y)


def less_than(x, y):
    return _cmp(torch.lt, x, y)


def less_equal(x, y):
    return _cmp(torch.le, x, y)


def logical_and(x, y, out=None):
    return _cmp(_tensor(torch.logical_and), x, y)


def logical_or(x, y, out=None):
    return _cmp(_tensor(torch.logical_or), x, y)


def logical_xor(x, y, out=None):
    return _cmp(_tensor(torch.logical_xor), x, y)


def logical_not(x, out=None):
    return torch.logical_not(x.detach())


def bitwise_and(x, y, out=None):
    return _cmp(torch.bitwise_and, x, y)


def bitwise_or(x, y, out=None):
    return _cmp(torch.bitwise_or, x, y)


def bitwise_xor(x, y, out=None):
    return _cmp(torch.bitwise_xor, x, y)


def bitwise_not(x, out=None):
    return torch.bitwise_not(x.detach())


def bitwise_left_shift(x, y, is_arithmetic=True, out=None):
    return _cmp(torch.bitwise_left_shift, x, y)


def bitwise_right_shift(x, y, is_arithmetic=True, out=None):
    return _cmp(torch.bitwise_right_shift, x, y)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def all(x, axis=None, keepdim=False):
    x = x.detach()
    if axis is None:
        return torch.all(x, tuple(range(x.dim())), keepdim=keepdim)
    return torch.all(x, _axes(axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False):
    x = x.detach()
    if axis is None:
        return torch.any(x, tuple(range(x.dim())), keepdim=keepdim)
    return torch.any(x, _axes(axis), keepdim=keepdim)


def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def in_dynamic_mode():
    """False in static-graph mode (``paddle.enable_static()``)."""
    graph = sys.modules.get("paddle_tpu_torch.static.graph")
    return graph is None or not graph.in_static_mode()
