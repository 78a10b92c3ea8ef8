"""``LayerNorm`` and ``GroupNorm`` layers, the counterparts of
``paddle_tpu/nn/layer/norm.py:98-158``: parameters ``weight`` (ones) and
``bias`` (zeros), default eps 1e-5, the forward through
:mod:`paddle_tpu_torch.nn.functional` (the Triton kernels on the card)."""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(self._normalized_shape, **kw))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape, **kw))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 data_format="NCHW", device=None, dtype=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(num_channels, **kw))
        self.bias = nn.Parameter(torch.zeros(num_channels, **kw))

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)
