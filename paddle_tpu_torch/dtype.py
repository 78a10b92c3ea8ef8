"""Paddle's dtype names and the default dtype, the counterparts of
``paddle_tpu/core/dtype.py``.

The names are torch dtypes (``float32`` is ``torch.float32``).
:func:`to_torch_dtype` reads a torch dtype, a NumPy dtype or one of
JAX's names (``"float32"``, ``"fp16"``, ``"bf16"``, ``"paddle.int64"``,
...).  :func:`set_default_dtype` sets the dtype that
``nn.Layer.create_parameter`` and the creation functions use when none
is given; it leaves ``torch.get_default_dtype()`` alone.
"""

from __future__ import annotations

import numpy as np
import torch

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int": int32,
    "int64": int64, "long": int64, "uint8": uint8,
    "bool": bool_, "complex64": complex64, "complex128": complex128,
}


def to_torch_dtype(dtype):
    """A torch dtype from a torch dtype, a name or a NumPy dtype (None
    stays None); raises ``ValueError`` on an unknown name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key.startswith("paddle."):
            key = key.split(".", 1)[1]
        if key not in _STR2DTYPE:
            raise ValueError(f"unknown dtype {dtype!r}")
        return _STR2DTYPE[key]
    return _STR2DTYPE[np.dtype(dtype).name]


def dtype_name(dtype):
    """``"float32"`` for ``torch.float32`` (and for any form
    :func:`to_torch_dtype` reads)."""
    return str(to_torch_dtype(dtype)).split(".")[-1]


_DEFAULT_DTYPE = [float32]


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def set_default_dtype(d):
    _DEFAULT_DTYPE[0] = to_torch_dtype(d)


__all__ = ["bfloat16", "bool_", "complex128", "complex64", "float16",
           "float32", "float64", "get_default_dtype", "int16", "int32",
           "int64", "int8", "set_default_dtype", "uint8"]
