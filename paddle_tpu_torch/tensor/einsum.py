"""``einsum``, the counterpart of ``paddle_tpu/tensor/einsum.py``."""

from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs

__all__ = ["einsum"]


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = operands[0]
    return torch.einsum(equation, *cast_inputs("einsum", *operands))
