"""Norm layers, the counterparts of ``paddle_tpu/nn/layer/norm.py``:
``LayerNorm`` and ``GroupNorm`` (``:98-158``; the CUDA kernels on the
card), ``RMSNorm`` (``:121-134``; weight only, eps 1e-6, plain torch as
JAX's), ``BatchNorm``/``BatchNorm1D/2D/3D`` (``:13-61``) and
``InstanceNorm1D/2D/3D`` (``:161-189``), each with parameters
``weight`` (ones) and ``bias`` (zeros) from ``Layer.create_parameter``,
default eps 1e-5, the forward through
:mod:`paddle_tpu_torch.nn.functional`.  ``weight_attr``/``bias_attr``
are JAX's; ``False`` leaves the parameter out.
BatchNorm keeps its running statistics in the buffers ``_mean`` (zeros)
and ``_variance`` (ones), JAX's ``state_dict`` keys; ``Module.to(dtype)``
casts them with the parameters, as JAX's ``Layer.to``.
``LocalResponseNorm`` and ``SpectralNorm`` (``:191-237``) have JAX's
arithmetic.  ``SyncBatchNorm`` waits for distributed training
(ROADMAP.md)."""

from __future__ import annotations

import math

import torch

from ..dtype import get_default_dtype
from ..tensor.manipulation import to_dtype
from . import functional as F
from .initializer import Constant, Normal
from .layers import Layer


def _affine(layer, shape, weight_attr, bias_attr, device):
    """JAX's norm parameters: ``weight`` ones and ``bias`` zeros, each
    left out (None) for an attr of False."""
    layer.weight = None if weight_attr is False else layer.create_parameter(
        shape, weight_attr, default_initializer=Constant(1.0), device=device)
    layer.bias = None if bias_attr is False else layer.create_parameter(
        shape, bias_attr, is_bias=True, device=device)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _affine(self, self._normalized_shape, weight_attr, bias_attr, device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class RMSNorm(Layer):
    """``paddle_tpu/nn/layer/norm.py:121-134``: weight ones, eps 1e-6,
    the forward through :func:`nn.functional.rms_norm` (JAX's plain
    path; ``incubate.nn.functional.fused_rms_norm`` is the kernel's
    entry)."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, None, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        _affine(self, [num_channels], weight_attr, bias_attr, device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine(self, [num_features], weight_attr, bias_attr, device)
        dt = to_dtype(dtype if dtype is not None else get_default_dtype())
        self.register_buffer("_mean", Constant(0.0)(
            [num_features], dt, device))
        self.register_buffer("_variance", Constant(1.0)(
            [num_features], dt, device))

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
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, dtype=dtype)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        self._epsilon = epsilon
        self._data_format = data_format
        _affine(self, [num_features], weight_attr, bias_attr, device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device,
                         dtype=dtype)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device,
                         dtype=dtype)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW"):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
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
        self.weight_u = self.create_parameter(
            [h], dtype=dtype, default_initializer=Normal(0.0, 1.0),
            device=device).requires_grad_(False)
        self.weight_v = self.create_parameter(
            [w], dtype=dtype, default_initializer=Normal(0.0, 1.0),
            device=device).requires_grad_(False)

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
