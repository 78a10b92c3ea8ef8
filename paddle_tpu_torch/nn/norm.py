"""Norm layers, the counterparts of ``paddle_tpu/nn/layer/norm.py``:
``LayerNorm`` and ``GroupNorm`` (``:98-158``; the CUDA kernels on the
card), ``RMSNorm`` (``:121-134``; weight only, eps 1e-6, plain torch as
JAX's), ``BatchNorm``/``BatchNorm1D/2D/3D`` (``:13-61``) and
``InstanceNorm1D/2D/3D`` (``:161-189``), each with parameters
``weight`` (ones) and ``bias`` (zeros), default eps 1e-5, the forward
through :mod:`paddle_tpu_torch.nn.functional`.  ``weight_attr=False`` /
``bias_attr=False`` leave a BatchNorm or InstanceNorm parameter out.
BatchNorm keeps its running statistics in the buffers ``_mean`` (zeros)
and ``_variance`` (ones), JAX's ``state_dict`` keys; ``Module.to(dtype)``
casts them with the parameters, as JAX's ``Layer.to``.
``LocalResponseNorm`` and ``SpectralNorm`` (``:191-237``) have JAX's
arithmetic.  ``SyncBatchNorm`` waits for distributed training
(ROADMAP.md)."""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import random as _random
from ..tensor.manipulation import to_dtype
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


class RMSNorm(nn.Module):
    """``paddle_tpu/nn/layer/norm.py:121-134``: weight ones, eps 1e-6,
    the forward through :func:`nn.functional.rms_norm` (JAX's plain
    path; ``incubate.nn.functional.fused_rms_norm`` is the kernel's
    entry)."""

    def __init__(self, normalized_shape, epsilon=1e-6, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._normalized_shape,
                                              device=device, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, None, self._epsilon)


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


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = (None if weight_attr is False else
                       nn.Parameter(torch.ones(num_features, **kw)))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(num_features, **kw)))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, device,
                         dtype)


class InstanceNorm1D(nn.Module):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(device=device, dtype=dtype)
        self.weight = (None if weight_attr is False else
                       nn.Parameter(torch.ones(num_features, **kw)))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(num_features, **kw)))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device, dtype)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, dtype=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device, dtype)


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW"):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(nn.Module):
    """``weight / sigma``, ``sigma`` the largest singular value of
    ``weight`` with dim ``dim`` first and the rest flattened, by
    ``power_iters`` power iterations from ``weight_u`` [h] and
    ``weight_v`` [w] (N(0, 1), parameters that take no gradient and that
    the forward does not update, as JAX's; ``nn/layer/norm.py:200-237``)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = math.prod(s for i, s in enumerate(weight_shape) if i != dim)
        kw = dict(device=device, dtype=to_dtype(dtype))
        self.weight_u = nn.Parameter(torch.empty(h, **kw),
                                     requires_grad=False)
        self.weight_v = nn.Parameter(torch.empty(w, **kw),
                                     requires_grad=False)
        with torch.no_grad():
            for p in (self.weight_u, self.weight_v):
                p.normal_(0.0, 1.0,
                          generator=_random.next_generator(p.device))

    def forward(self, weight):
        wm = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                  -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._epsilon)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + self._epsilon)
        return weight / (u @ wm @ v)
