"""Building blocks of the vision model zoo, the counterparts of
``paddle_tpu/vision/models/_ops.py``, and the constructors' shared
set-up: the device (``cuda`` unless the caller passes ``"cpu"``), the
initial values' stream (with ``seed``, a private stream seeded by it)
and the refusal of pretrained weights."""

from __future__ import annotations

import contextlib


from ... import random as _random
from ...device import resolve_device
from ...nn import BatchNorm2D, Conv2D, ReLU
from ...nn.layers import Layer


def make_divisible(v, divisor=8, min_value=None):
    """``v`` rounded to a multiple of ``divisor``, not below
    ``min_value`` (default ``divisor``) and not below 0.9 v."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def model_kw(device, dtype):
    """The layers' ``device``/``dtype`` keywords of a model built on
    ``device`` (resolved: ``cuda`` unless asked otherwise)."""
    return dict(device=resolve_device(device), dtype=dtype)


def seeded(seed):
    """Draw initial values from a private stream seeded by ``seed``, or
    from this thread's stream when it is None."""
    return (contextlib.nullcontext() if seed is None
            else _random.fork_rng(seed))


def no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError("pretrained weights are not in the "
                                  "repository")


class ConvBNReLU(Layer):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, groups=groups, bias_attr=False,
                           **kw)
        self.bn = BatchNorm2D(out_ch, **kw)
        self.relu = ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))
