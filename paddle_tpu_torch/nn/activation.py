"""``GELU``, ``ReLU`` and ``Tanh``, the counterparts of
``paddle_tpu/nn/layer/activation.py``."""

from __future__ import annotations

from torch import nn

from . import functional as F


class GELU(nn.Module):
    def __init__(self, approximate=False):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)
