"""``paddle.nn.utils``, the counterpart of ``paddle_tpu/nn/utils/__init__.py``.

``weight_norm`` makes ``<name>_g`` (the norm of each slice along
``dim``; over every axis for ``dim=None``) and ``<name>_v`` the layer's
parameters in place of ``<name>``, which a forward pre-hook recomputes
as ``g * v / max(||v||, 1e-12)`` before each forward; ``spectral_norm``
keeps ``<name>_orig`` and recomputes ``<name>`` as ``w / sigma``, sigma
from ``n_power_iterations`` steps of power iteration from a running
``u`` (NumPy's ``RandomState(0)`` at the start, as JAX's; a forward
without gradient carries it to the next, one with gradient leaves it, as
JAX's, whose traced ``u`` is never stored).  Both hooks are applied once at once, as JAX's.
``parameters_to_vector``/``vector_to_parameters`` flatten and refill;
``clip_grad_norm_`` scales by ``min(max_norm / (total + 1e-6), 1)``
(``nn.clip_grad_norm_`` by ``max(total, 1e-6)``, as JAX's)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import Parameter
from ..clip import _with_grads, clip_grad_value_, total_norm


def _norm_except(v, dim):
    axes = tuple(i for i in range(v.dim()) if dim is None or i != dim)
    return torch.sqrt(torch.sum(torch.square(v), dim=axes, keepdim=True))


class _WeightNormHook:
    def __init__(self, layer, name, dim):
        self.name = name
        self.dim = dim
        w = getattr(layer, name).detach()
        layer.add_parameter(name + "_g", Parameter(_norm_except(w, dim)))
        layer.add_parameter(name + "_v", Parameter(w.clone()))
        del layer._parameters[name]

    def __call__(self, layer, inputs):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        setattr(layer, self.name, g * v / torch.clamp(
            _norm_except(v, self.dim), min=1e-12))


def weight_norm(layer, name="weight", dim=0):
    hook = _WeightNormHook(layer, name, dim)
    layer._weight_norm_handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_hook = hook
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    hook = getattr(layer, "_weight_norm_hook", None)
    if hook is None:
        raise ValueError("layer has no weight_norm applied")
    g = getattr(layer, name + "_g").detach()
    v = getattr(layer, name + "_v").detach()
    w = g * v / torch.clamp(_norm_except(v, hook.dim), min=1e-12)
    layer._weight_norm_handle.remove()
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    delattr(layer, name)
    layer.add_parameter(name, Parameter(w))
    del layer._weight_norm_handle
    del layer._weight_norm_hook
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    w = getattr(layer, name).detach()
    dim = 0 if dim is None else dim
    h = int(w.shape[dim])
    u0 = np.random.RandomState(0).randn(h).astype(np.float32)
    layer._sn_u = torch.from_numpy(u0 / max(np.linalg.norm(u0), eps)).to(
        w.device)
    layer.add_parameter(name + "_orig", Parameter(w.clone()))
    del layer._parameters[name]

    def hook(lyr, inputs):
        worig = getattr(lyr, name + "_orig")
        wm = worig.movedim(dim, 0).reshape(h, -1)
        u = lyr._sn_u
        for _ in range(n_power_iterations):
            v = wm.T @ u
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
            u = wm @ v
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
        if not torch.is_grad_enabled():
            lyr._sn_u = u.detach()
        setattr(lyr, name, worig / (u @ (wm @ v)))

    layer._spectral_norm_handle = layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Refill each parameter from the next ``numel`` values of ``vec``,
    cast to its dtype."""
    parameters = list(parameters)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = math.prod(p.shape)
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n
    return parameters


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    params = _with_grads(parameters)
    if not params:
        return torch.zeros(())
    total = total_norm([p.grad for p in params], norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite gradient norm in clip_grad_norm_")
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(scale.to(p.grad.dtype))
    return total


__all__ = [
    "weight_norm", "remove_weight_norm", "spectral_norm",
    "parameters_to_vector", "vector_to_parameters",
    "clip_grad_norm_", "clip_grad_value_",
]
