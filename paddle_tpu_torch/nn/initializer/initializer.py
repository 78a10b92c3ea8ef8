"""The weight initializers, the counterparts of
``paddle_tpu/nn/initializer/initializer.py``: each is a function of
``(shape, dtype)`` (and, in the port, ``device``, resolved as every
entry point's: the card unless the caller or ``set_device`` named the
CPU) that makes a new tensor.  A random one takes one key of the
port's counter stream (:mod:`paddle_tpu_torch.random`) a call and draws
on the tensor's device, so the draw depends only on the seed and the
keys taken before it (the bits differ from JAX's threefry bits; shapes,
fans and moments are JAX's).  ``_fans`` is JAX's term for term: a 2-D
shape is ``[in, out]`` (paddle's ``Linear`` layout), a convolution's
``[out, in, *k]``."""

from __future__ import annotations

import math

import numpy as np
import torch

from ... import random as _random
from ...device import resolve_device
from ...dtype import to_torch_dtype


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=torch.float32, device=None):
        raise NotImplementedError

    @staticmethod
    def _empty(shape, dtype, device):
        """``"meta"`` (shapes without values) is taken as it is."""
        return torch.empty(tuple(int(s) for s in shape),
                           dtype=to_torch_dtype(dtype),
                           device=(device if str(device) == "meta"
                                   else resolve_device(device)))

    @staticmethod
    def _generator(t):
        return _random.next_generator(t.device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None):
        return self._empty(shape, dtype, device).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None):
        t = self._empty(shape, dtype, device)
        return t.normal_(self.mean, self.std, generator=self._generator(t))


class TruncatedNormal(Initializer):
    """N(0, 1) truncated to ``[a, b]``, then ``* std + mean`` (JAX's
    order), drawn in f32 (f64 for f64) and cast."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=torch.float32, device=None):
        t = self._empty(shape, dtype, device)
        wide = torch.float64 if t.dtype == torch.float64 else torch.float32
        z = torch.empty(t.shape, dtype=wide, device=t.device)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b,
                                    generator=self._generator(t))
        return t.copy_(z * self.std + self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device=None):
        t = self._empty(shape, dtype, device)
        return t.uniform_(self.low, self.high, generator=self._generator(t))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        fin, fout = _fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        std = self.gain * math.sqrt(2.0 / (fin + fout))
        return Normal(0.0, std)(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        fin, fout = _fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        limit = self.gain * math.sqrt(6.0 / (fin + fout))
        return Uniform(-limit, limit)(shape, dtype, device)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype=torch.float32, device=None):
        fin = self.fan_in or _fans(shape)[0]
        std = _kaiming_gain(self.negative_slope,
                            self.nonlinearity) / math.sqrt(fin)
        return Normal(0.0, std)(shape, dtype, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype=torch.float32, device=None):
        fin = self.fan_in or _fans(shape)[0]
        limit = _kaiming_gain(self.negative_slope, self.nonlinearity) * \
            math.sqrt(3.0 / fin)
        return Uniform(-limit, limit)(shape, dtype, device)


class Assign(Initializer):
    """``value`` (an array, a list or a tensor), reshaped to ``shape``."""

    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None):
        v = self.value
        v = v.detach() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        return self._empty(shape, dtype, device).copy_(
            v.reshape(tuple(shape)))


class Dirac(Initializer):
    """A convolution kernel that passes channel ``i % in`` through to
    output ``i`` (at the kernel's centre), for ``min(out, in * groups)``
    outputs."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, device=None):
        out = np.zeros(tuple(shape), dtype=np.float32)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centers] = 1.0
        return self._empty(shape, dtype, device).copy_(torch.from_numpy(out))


class Orthogonal(Initializer):
    """``jax.nn.initializers.orthogonal(scale=gain)``: the Q of a
    Gaussian matrix [rows, cols] (``cols`` the last axis), its columns'
    signs fixed by R's diagonal, transposed when rows < cols, in f32."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        if len(shape) < 2:
            raise ValueError(f"Orthogonal needs 2 or more dims: {shape}")
        t = self._empty(shape, dtype, device)
        cols = int(shape[-1])
        rows = int(np.prod(shape)) // cols
        a = torch.empty(max(rows, cols), min(rows, cols),
                        dtype=torch.float32, device=t.device)
        a.normal_(0.0, 1.0, generator=self._generator(t))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return t.copy_((self.gain * q).reshape(t.shape))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"unknown nonlinearity {nonlinearity}")
