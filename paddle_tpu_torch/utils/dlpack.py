"""``paddle.utils.dlpack``, the counterpart of
``paddle_tpu/utils/dlpack.py``: zero-copy exchange through the DLPack
protocol.  ``to_dlpack`` returns the tensor itself, which carries
``__dlpack__``/``__dlpack_device__`` (every consumer's ``from_dlpack``
takes it, with none of a bare capsule's consumed-once hazard), as JAX's
returns its array; ``from_dlpack`` takes such an object or a bare
capsule (``torch.utils.dlpack.from_dlpack``).  A card tensor stays on
the card and shares its storage."""

from __future__ import annotations

import torch
from torch.utils import dlpack as _dlpack

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """``x`` for a DLPack consumer: the tensor itself."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"to_dlpack takes a tensor, not {type(x).__name__}")
    return x


def from_dlpack(dlpack):
    """A tensor over the memory of a DLPack-protocol object (a tensor, a
    NumPy array, ...) or a bare capsule, without a copy."""
    return _dlpack.from_dlpack(dlpack)
