"""Convolution layers, the counterparts of ``paddle_tpu/nn/layer/conv.py``:
``weight`` ``[out, in/groups, *k]`` (transposed: ``[in, out/groups,
*k]``) and ``bias`` ``[out]``, both from U(-1/sqrt(fan_in),
1/sqrt(fan_in)) with ``fan_in = in/groups * prod(k)``, drawn from the
port's counter stream (:mod:`paddle_tpu_torch.random`), one key a
parameter.  ``bias_attr=False`` leaves out the bias.  The forward goes
through :mod:`paddle_tpu_torch.nn.functional` (cuDNN on the card)."""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import random as _random
from . import functional as F


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, bias_attr,
                 data_format, dims, transposed=False, output_padding=0,
                 device=None, dtype=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode {padding_mode!r}: only "
                                      "'zeros' is ported")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = list(F._ntuple(kernel_size, dims))
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        shape = ([in_channels, out_channels // groups] if transposed else
                 [out_channels, in_channels // groups]) + self._kernel_size
        bound = 1.0 / math.sqrt(in_channels // groups
                                * math.prod(self._kernel_size))
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(self._uniform(shape, bound, kw))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(self._uniform([out_channels], bound, kw)))

    @staticmethod
    def _uniform(shape, bound, kw):
        t = torch.empty(shape, **kw)
        with torch.no_grad():
            t.uniform_(-bound, bound,
                       generator=_random.next_generator(t.device))
        return t

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}, data_format={self._data_format}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCL", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, bias_attr,
                         data_format, 1, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCHW", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, bias_attr,
                         data_format, 2, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 bias_attr=None, data_format="NCDHW", device=None,
                 dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, bias_attr,
                         data_format, 3, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 bias_attr=None, data_format="NCL", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", bias_attr,
                         data_format, 1, True, output_padding, device, dtype)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 bias_attr=None, data_format="NCHW", device=None,
                 dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", bias_attr,
                         data_format, 2, True, output_padding, device, dtype)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 bias_attr=None, data_format="NCDHW", device=None,
                 dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", bias_attr,
                         data_format, 3, True, output_padding, device, dtype)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)
