"""Tensors, parameters and autograd at Paddle's names, the counterparts
of ``paddle_tpu/core/tensor.py`` (``Tensor``, ``Parameter``,
``to_tensor``), ``core/tape.py`` (the grad modes) and
``core/autograd_engine.py:260`` (``grad``).

``Tensor`` is ``torch.Tensor``: the port's tensors stay torch tensors
(``ROADMAP.md`` Queue 3, a known difference), and torch's autograd is
the tape.  ``Parameter`` is an ``nn.Parameter`` that carries JAX's
attributes: ``name``, ``trainable``, ``optimize_attr["learning_rate"]``
(the optimizer multiplies its rate by it), ``regularizer`` (which
replaces the optimizer's ``weight_decay`` for it), ``need_clip``, and
``stop_gradient`` (``not requires_grad``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .dtype import to_torch_dtype

Tensor = torch.Tensor

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled
set_grad_enabled = torch.set_grad_enabled


class Parameter(nn.Parameter):
    """``Parameter(data, dtype=None, name=None, trainable=True)``: a
    trainable tensor (``requires_grad`` unless ``trainable`` is False)
    with JAX's ``Parameter`` attributes."""

    def __new__(cls, data, dtype=None, name=None, trainable=True):
        if isinstance(dtype, bool):          # torch's (data, requires_grad)
            dtype, trainable = None, dtype
        t = data.detach() if isinstance(data, torch.Tensor) else \
            torch.as_tensor(np.asarray(data))
        if dtype is not None:
            t = t.to(to_torch_dtype(dtype))
        self = super().__new__(cls, t, requires_grad=bool(trainable))
        self.name = name
        self.trainable = bool(trainable)
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        return self

    def __init__(self, *args, **kwargs):
        pass

    @property
    def name(self):          # torch.Tensor's own ``name`` is read-only
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = Parameter(self.data.clone(memory_format=torch.preserve_format),
                        trainable=self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out


def _x64_off(dtype):
    """JAX's arrays with x64 off: float64 -> float32, int64 -> int32."""
    return {torch.float64: torch.float32, torch.int64: torch.int32}.get(
        dtype, dtype)


def _int64_off(dtype):
    """A dtype asked for by name: int64 -> int32, as the creation
    functions (``tensor.creation.jax_dtype``); float64 stays."""
    return torch.int32 if dtype == torch.int64 else dtype


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new tensor of ``data`` (a scalar, a list,
    a NumPy array or a tensor) on ``place`` (default: the current device,
    :func:`device.resolve_device`), in ``dtype``; with no ``dtype``,
    JAX's rules with x64 off (a Python float is float32, an int int32,
    float64 and int64 data float32 and int32; an int64 asked for is
    int32, a float64 float64).  ``stop_gradient=False``
    makes it require a gradient."""
    dev = resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach()
        dt = t.dtype if dtype is None else _int64_off(to_torch_dtype(dtype))
    else:
        t = torch.as_tensor(np.asarray(data))
        dt = _x64_off(t.dtype) if dtype is None else \
            _int64_off(to_torch_dtype(dtype))
    t = t.to(device=dev, dtype=dt, copy=True)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, a list; an output without a ``grad_outputs`` entry
    starts from ones, and the graph is kept unless ``retain_graph`` is
    False, as JAX's.  Raises on an unused input unless
    ``allow_unused``."""
    outputs = [outputs] if isinstance(outputs, torch.Tensor) else \
        list(outputs)
    inputs = [inputs] if isinstance(inputs, torch.Tensor) else list(inputs)
    if grad_outputs is None or isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs] * len(outputs) if grad_outputs is \
            None else [grad_outputs]
    seeds = [torch.ones_like(o) if g is None else g
             for o, g in zip(outputs, grad_outputs)]
    return list(torch.autograd.grad(
        outputs, inputs, seeds,
        retain_graph=True if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=allow_unused))


__all__ = ["Parameter", "Tensor", "enable_grad", "grad", "is_grad_enabled",
           "no_grad", "set_grad_enabled", "to_tensor"]
