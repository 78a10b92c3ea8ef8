"""``paddle.iinfo`` and ``paddle.finfo``, the counterparts of
``paddle_tpu/framework/dtype_info.py``: NumPy's limits (torch's for
bfloat16, which NumPy lacks), from any dtype form
:func:`dtype.to_torch_dtype` reads."""

from __future__ import annotations

import numpy as np
import torch

from ..dtype import dtype_name, to_torch_dtype


class iinfo:
    def __init__(self, dtype):
        info = np.iinfo(np.dtype(dtype_name(dtype)))
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = str(info.dtype)

    def __repr__(self):
        return (f"iinfo(min={self.min}, max={self.max}, bits={self.bits}, "
                f"dtype={self.dtype})")


class finfo:
    def __init__(self, dtype):
        td = to_torch_dtype(dtype)
        info = (torch.finfo(td) if td == torch.bfloat16
                else np.finfo(np.dtype(dtype_name(td))))
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = self.tiny
        # NumPy's resolution (10 ** -precision) in the dtype itself
        self.resolution = float(torch.tensor(float(info.resolution),
                                             dtype=td))
        self.bits = int(info.bits)
        self.dtype = dtype_name(td)

    def __repr__(self):
        return (f"finfo(min={self.min}, max={self.max}, eps={self.eps}, "
                f"bits={self.bits}, dtype={self.dtype})")
