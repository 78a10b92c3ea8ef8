"""Attribute queries, the counterparts of ``paddle_tpu/tensor/attribute.py``:
``shape``, ``rank`` and ``numel`` as int32 tensors on ``x``'s device
(``shape`` is :func:`.manipulation.shape`, the one JAX's root exports
too), and the dtype predicates as Python bools."""

from __future__ import annotations

import torch

from .manipulation import shape

__all__ = ["is_complex", "is_floating_point", "is_integer", "numel",
           "rank", "shape"]


def rank(x):
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


def is_complex(x):
    return x.is_complex()


def is_floating_point(x):
    return x.is_floating_point()


def is_integer(x):
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)
