"""``matmul``, the counterpart of ``paddle_tpu/tensor/math.py``'s, asking
``amp`` for its inputs' dtype under JAX's op name."""

from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs


def matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y``, with the last two dims of either transposed first (a
    1-D operand is not transposed)."""
    x, y = cast_inputs("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
