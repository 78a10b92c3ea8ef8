"""``nn.Layer``, the counterpart of ``paddle_tpu/nn/layer/layers.py``:
``torch.nn.Module`` with Paddle's methods added.

Torch's ``__call__``, ``__getattr__``, ``__setattr__`` and ``__delattr__``
run unchanged (a layer's forward costs what a module's does), so
parameters, buffers and sublayers register as torch's do, and Paddle's
forward hooks are torch's: a pre-hook ``hook(layer, inputs)`` may return
new inputs, a post-hook ``hook(layer, inputs, output)`` a new output,
and each registration returns JAX's ``HookRemoveHelper``.

What Paddle adds: ``create_parameter`` (JAX's, ``layers.py:114-142``:
the attr's initializer, else ``default_initializer``, else
``Constant(0)`` for a bias and ``XavierUniform`` otherwise; the attr's
``learning_rate``, ``regularizer`` and ``trainable`` on the
``Parameter``; the dtype the layer was built with, else
``dtype.get_default_dtype()``; on ``device``, resolved as every entry
point's: the card unless the caller or ``set_device`` named the CPU),
``add_parameter``, ``add_sublayer``, ``register_buffer(...,
persistable=)``, ``sublayers``/``named_sublayers``, ``full_name``,
``set_state_dict`` (JAX's: copies values in, returns ``(missing,
unexpected)``, raises on a shape mismatch), ``clear_gradients``,
``astype`` and JAX's ``to(device=, dtype=, blocking=)`` (Paddle's dtype
and device names; torch's forms still work).  ``state_dict()`` lists
the parameters first and then the persistable buffers, as JAX's;
``parameters()`` stays torch's iterator (JAX's is a list).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ..core import Parameter
from ..dtype import get_default_dtype, to_torch_dtype

_NAME_COUNTERS = {}


def _unique_name(prefix: str) -> str:
    idx = _NAME_COUNTERS.get(prefix, 0)
    _NAME_COUNTERS[prefix] = idx + 1
    return f"{prefix}_{idx}"


class HookRemoveHelper:
    """Removes the hook registered under ``key`` from ``hooks``."""

    def __init__(self, hooks, key):
        self._hooks = hooks
        self._key = key

    def remove(self):
        self._hooks.pop(self._key, None)


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = dtype
        self._full_name = _unique_name(name_scope
                                       or type(self).__name__.lower())

    # ---------------- construction ----------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None):
        from ..framework.param_attr import ParamAttr
        from .initializer import Constant, XavierUniform

        attr = ParamAttr._to_attr(attr)
        if dtype is None:
            dtype = self._dtype if self._dtype is not None else \
                get_default_dtype()
        if attr is not None and attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        else:
            init = Constant(0.0) if is_bias else XavierUniform()
        with torch.no_grad():
            data = init(tuple(int(s) for s in shape), to_torch_dtype(dtype),
                        device)
        p = Parameter(data, name=(attr.name if attr is not None and attr.name
                                  else _unique_name("param")))
        if attr is not None:
            p.optimize_attr["learning_rate"] = attr.learning_rate
            p.regularizer = attr.regularizer
            p.need_clip = attr.need_clip
            if not attr.trainable:
                p.requires_grad_(False)
                p.trainable = False
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """torch's, with Paddle's ``persistable`` (torch's ``persistent``
        wins where given); an array becomes a tensor."""
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    # ---------------- traversal ----------------
    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        for name, m in self.named_modules(memo=layers_set, prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def full_name(self):
        return self._full_name

    # ---------------- state ----------------
    def state_dict(self, *args, destination=None, prefix="",
                   keep_vars=False):
        if args or destination is not None:      # torch's recursion
            return super().state_dict(*args, destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        sd = super().state_dict(prefix=prefix, keep_vars=keep_vars)
        params = {prefix + n for n, _ in
                  self.named_parameters(remove_duplicate=False)}
        out = OrderedDict((k, v) for k, v in sd.items() if k in params)
        out.update((k, v) for k, v in sd.items() if k not in params)
        out._metadata = sd._metadata
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict(keep_vars=True)
        unexpected = []
        with torch.no_grad():
            for name, value in state_dict.items():
                if name not in own:
                    unexpected.append(name)
                    continue
                target = own[name]
                if not isinstance(value, torch.Tensor):
                    value = torch.as_tensor(np.asarray(value))
                if tuple(target.shape) != tuple(value.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: got "
                        f"{tuple(value.shape)}, expected "
                        f"{tuple(target.shape)}")
                target.copy_(value)
        missing = [name for name in own if name not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    def to(self, *args, **kwargs):
        """JAX's ``to(device=None, dtype=None, blocking=None)``: the
        floating parameters and buffers cast to ``dtype`` (a Paddle name
        such as ``"float16"``, or a torch dtype) and moved to ``device``
        (``"gpu"``, ``"gpu:0"``, ``"cpu"``, resolved as every entry
        point's: :func:`device.resolve_device`).  torch's forms
        (``to(torch.float16)``, ``to(tensor)``, ``memory_format=``) run
        as torch's."""
        if (args and isinstance(args[0], (torch.Tensor, torch.dtype))) \
                or "memory_format" in kwargs or "tensor" in kwargs:
            return super().to(*args, **kwargs)
        from ..device import resolve_device

        names = ("device", "dtype", "blocking")
        given = dict(zip(names, args))
        given.update(kwargs)
        blocking = given.pop("blocking", None)
        move = {"non_blocking": given.pop("non_blocking", False)
                or blocking is False}
        if given.get("device") is not None:
            move["device"] = resolve_device(given["device"])
        if given.get("dtype") is not None:
            move["dtype"] = to_torch_dtype(given["dtype"])
        return super().to(**move)

    def astype(self, dtype):
        return self.to(dtype=to_torch_dtype(dtype))

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    # ---------------- hooks ----------------
    def register_forward_pre_hook(self, hook, **kwargs):
        handle = super().register_forward_pre_hook(hook, **kwargs)
        return handle if kwargs else \
            HookRemoveHelper(self._forward_pre_hooks, handle.id)

    def register_forward_post_hook(self, hook):
        handle = self.register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, handle.id)
