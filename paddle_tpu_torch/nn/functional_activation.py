"""Activation functionals, the counterparts of
``paddle_tpu/nn/functional/activation.py`` (all 31) and ``elu_`` of its
``__init__``; re-exported by :mod:`paddle_tpu_torch.nn.functional`.

Each computes JAX's arithmetic where it departs from torch's function of
the same name: ``hardsigmoid`` is ``clip(slope x + offset, 0, 1)`` with
paddle's slope 0.1666667 (``activation.py:47``; ``F.hardsigmoid``'s is
1/6), ``softplus`` is linear above ``threshold`` and ``logaddexp`` below,
``mish`` takes that ``logaddexp`` softplus.  A Python constant meets a
tensor as JAX's weak type does: rounded to the tensor's dtype first
(:func:`weak`).  ``rrelu`` in training and ``gumbel_softmax`` draw from
the port's counter stream (:mod:`paddle_tpu_torch.random`), one key a
call; their bits differ from JAX's threefry bits by design.  Each asks
``amp`` for its input's dtype under JAX's op name (``softmax`` and
``log_softmax`` are on the black list: f32 under an ``auto_cast``
scope).  The in-place forms (``relu_``, ``softmax_``, ``elu_``) replace
the tensor's data, as JAX replaces the buffer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from .. import random as _random
from ..amp.auto_cast import cast_inputs, to_torch_dtype


def weak(v, t):
    """The Python float ``v`` as JAX's weak-typed constant beside the
    tensor ``t``: rounded to ``t``'s dtype first (0.9 is 0.8984375
    beside bf16), where torch would keep it in f32."""
    return torch.tensor(v, dtype=t.dtype).item()


def _cast(name, x):
    return cast_inputs(name, x)[0]


def relu(x):
    return torch.relu(_cast("relu", x))


def relu_(x):
    x.data = torch.relu(x.detach())
    return x


def relu6(x):
    return _cast("relu6", x).clamp(0.0, 6.0)


def gelu(x, approximate=False):
    """Exact (erf) GELU, or the tanh approximation with ``approximate``."""
    return TF.gelu(_cast("gelu", x),
                   approximate="tanh" if approximate else "none")


def silu(x):
    """``x * sigmoid(x)`` (``activation.py:35-36``)."""
    return TF.silu(_cast("silu", x))


def swish(x):
    return silu(x)


def sigmoid(x):
    return torch.sigmoid(_cast("sigmoid", x))


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    """``clip(slope x + offset, 0, 1)`` (``activation.py:46-47``)."""
    x = _cast("hardsigmoid", x)
    return (weak(slope, x) * x + weak(offset, x)).clamp(0.0, 1.0)


def hardswish(x):
    """``x clip(x + 3, 0, 6) / 6``."""
    x = _cast("hardswish", x)
    return x * (x + 3.0).clamp(0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002  (paddle's names)
    return _cast("hardtanh", x).clamp(min, max)


def hardshrink(x, threshold=0.5):
    x = _cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0)


def tanh(x):
    return torch.tanh(_cast("tanh", x))


def tanhshrink(x):
    x = _cast("tanhshrink", x)
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01):
    x = _cast("leaky_relu", x)
    return torch.where(x >= 0, x, weak(negative_slope, x) * x)


def prelu(x, weight, data_format="NCHW"):
    """``where(x >= 0, x, w x)``: one weight, or one a channel (dim 1,
    or the last for a channels-last ``data_format``)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith("NC") else x.dim() - 1] = \
            weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False):
    """Negative inputs times a slope: in training one U(lower, upper)
    draw an element (one key), else ``(lower + upper) / 2``."""
    x = _cast("rrelu", x)
    if training:
        u = torch.rand(x.shape, generator=_random.next_generator(x.device),
                       device=x.device, dtype=x.dtype)
        r = u * (upper - lower) + lower
        return torch.where(x >= 0, x, r * x)
    return torch.where(x >= 0, x, weak((lower + upper) / 2.0, x) * x)


def elu(x, alpha=1.0):
    x = _cast("elu", x)
    return torch.where(x > 0, x, weak(alpha, x) * torch.expm1(
        torch.where(x > 0, 0.0, x)))


def elu_(x, alpha=1.0):
    x.data = elu(x.detach(), alpha)
    return x


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    x = _cast("selu", x)
    return weak(scale, x) * torch.where(x > 0, x,
                                        weak(alpha, x) * torch.expm1(x))


def celu(x, alpha=1.0):
    """``max(x, 0) + alpha expm1(min(x, 0) / alpha)`` (``jax.nn.celu``)."""
    x = _cast("celu", x)
    a = weak(alpha, x)
    return x.clamp(min=0.0) + a * torch.expm1(x.clamp(max=0.0) / a)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mish(x):
    x = _cast("mish", x)
    return x * torch.tanh(_softplus(x))


def softplus(x, beta=1.0, threshold=20.0):
    """``x`` where ``beta x > threshold``, else ``log(1 + exp(beta x)) /
    beta``."""
    x = _cast("softplus", x)
    b = weak(beta, x)
    return torch.where(x * b > threshold, x, _softplus(x * b) / b)


def softshrink(x, threshold=0.5):
    x = _cast("softshrink", x)
    t = weak(threshold, x)
    return torch.where(x > t, x - t, torch.where(x < -t, x + t, 0.0))


def softsign(x):
    x = _cast("softsign", x)
    return x / (x.abs() + 1.0)


def thresholded_relu(x, threshold=1.0, value=0.0):
    x = _cast("thresholded_relu", x)
    return torch.where(x > threshold, x, value)


def log_sigmoid(x):
    return TF.logsigmoid(_cast("log_sigmoid", x))


def softmax(x, axis=-1, dtype=None):
    """Softmax along ``axis``, after a cast to ``dtype`` if given."""
    x = _cast("softmax", x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def softmax_(x, axis=-1, dtype=None):
    x.data = torch.softmax(x.detach(), dim=axis)
    return x


def log_softmax(x, axis=-1, dtype=None):
    x = _cast("log_softmax", x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g = -log(-log
    u)``, ``u`` uniform on ``[tiny, 1)`` (one key); with ``hard`` the
    one-hot of the argmax carrying the soft sample's gradient."""
    x = _cast("gumbel_softmax", x)
    tiny = torch.finfo(x.dtype).tiny
    u = torch.rand(x.shape, generator=_random.next_generator(x.device),
                   device=x.device, dtype=x.dtype).clamp(min=tiny)
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y


def glu(x, axis=-1):
    """The first half along ``axis`` times the sigmoid of the second."""
    a, b = _cast("glu", x).chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1):
    """The max over each run of ``groups`` along ``axis``: ``C`` channels
    become ``C // groups``."""
    x = _cast("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


__all__ = [
    "celu", "elu", "elu_", "gelu", "glu", "gumbel_softmax", "hardshrink",
    "hardsigmoid", "hardswish", "hardtanh", "leaky_relu", "log_sigmoid",
    "log_softmax", "maxout", "mish", "prelu", "relu", "relu6", "relu_",
    "rrelu", "selu", "sigmoid", "silu", "softmax", "softmax_", "softplus",
    "softshrink", "softsign", "swish", "tanh", "tanhshrink",
    "thresholded_relu",
]
