"""Pooling layers, the counterparts of ``paddle_tpu/nn/layer/pooling.py``
(all of them).  ``MaxPool*(return_mask=True)`` returns ``(out, mask)``,
the mask ``MaxUnPool*`` takes back; the adaptive max pools accept
``return_mask`` and ignore it, as JAX's (ROADMAP.md Queue 3)."""

from __future__ import annotations

import functools

from . import functional as F
from .layers import Layer


class _Pool(Layer):
    def __init__(self, fn, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self._fn = functools.partial(fn, **kw)
        self._kernel_size = kernel_size
        self._stride = stride
        self._padding = padding

    def forward(self, x):
        return self._fn(x, self._kernel_size, self._stride, self._padding)


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False):
        super().__init__(F.max_pool1d, kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW"):
        super().__init__(F.max_pool2d, kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW"):
        super().__init__(F.max_pool3d, kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False):
        super().__init__(F.avg_pool1d, kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW"):
        super().__init__(F.avg_pool2d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW"):
        super().__init__(F.avg_pool3d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=data_format)


class _Adaptive(Layer):
    def __init__(self, fn, output_size, **kw):
        super().__init__()
        self._fn = functools.partial(fn, **kw)
        self._output_size = output_size

    def forward(self, x):
        return self._fn(x, self._output_size)


class AdaptiveAvgPool1D(_Adaptive):
    def __init__(self, output_size):
        super().__init__(F.adaptive_avg_pool1d, output_size)


class AdaptiveAvgPool2D(_Adaptive):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__(F.adaptive_avg_pool2d, output_size,
                         data_format=data_format)


class AdaptiveAvgPool3D(_Adaptive):
    def __init__(self, output_size, data_format="NCDHW"):
        super().__init__(F.adaptive_avg_pool3d, output_size,
                         data_format=data_format)


class AdaptiveMaxPool1D(_Adaptive):
    def __init__(self, output_size, return_mask=False):
        super().__init__(F.adaptive_max_pool1d, output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool2D(_Adaptive):
    def __init__(self, output_size, return_mask=False):
        super().__init__(F.adaptive_max_pool2d, output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool3D(_Adaptive):
    def __init__(self, output_size, return_mask=False):
        super().__init__(F.adaptive_max_pool3d, output_size,
                         return_mask=return_mask)


class _MaxUnPool(Layer):
    def __init__(self, fn, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self._fn = functools.partial(fn, **kw)
        self._args = (kernel_size, stride, padding)

    def forward(self, x, indices):
        return self._fn(x, indices, *self._args)


class MaxUnPool1D(_MaxUnPool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None):
        super().__init__(F.max_unpool1d, kernel_size, stride, padding,
                         data_format=data_format, output_size=output_size)


class MaxUnPool2D(_MaxUnPool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None):
        super().__init__(F.max_unpool2d, kernel_size, stride, padding,
                         data_format=data_format, output_size=output_size)


class MaxUnPool3D(_MaxUnPool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None):
        super().__init__(F.max_unpool3d, kernel_size, stride, padding,
                         data_format=data_format, output_size=output_size)
