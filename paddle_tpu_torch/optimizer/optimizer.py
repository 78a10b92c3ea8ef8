"""Optimizer base, as ``paddle_tpu/optimizer/optimizer.py``.

Every optimizer's math is one array function,
``_update(param, grad, state, lr) -> (new_param, new_state)``, the JAX
package's design carried over: :meth:`Optimizer.step` (which
``jit.TrainStep`` calls) applies it parameter by parameter.  The results
are written back in place (``param.copy_``), so the parameters keep
their storage; the per-parameter state is a dict of tensors on the
parameter's device.

The optimizer lives on ``device`` (``cuda`` unless the caller passes
``"cpu"``) and refuses parameters elsewhere.  ``parameters`` may be
tensors or ``(name, tensor)`` pairs (``model.named_parameters()``); the
names key :meth:`state_dict` as ``"<name>.<accumulator>"``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, device=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self.device = resolve_device(device)
        self._parameter_list = []
        self._param_names = {}
        for i, item in enumerate(parameters):
            pname, p = item if isinstance(item, tuple) else (f"param_{i}",
                                                             item)
            if p.device != self.device:
                raise ValueError(f"parameter {pname} lives on {p.device}, "
                                 f"the optimizer on {self.device}")
            self._parameter_list.append(p)
            self._param_names[id(p)] = pname
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        # coupled L2 coefficient (a float; paddle's regularizer objects
        # are not ported)
        self._weight_decay = float(weight_decay or 0.0)
        self._cur_wd = self._weight_decay
        self._accumulators = {}      # id(param) -> {state name: tensor}
        self._step_count = 0

    # -------- lr --------
    def get_lr(self):
        from .lr import LRScheduler

        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.get_lr()
        return float(self._learning_rate)

    # -------- state --------
    def _state_for(self, p):
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._init_state(p)
        return st

    def _init_state(self, p):
        return {}

    def state_dict(self):
        """``{"<param name>.<accumulator>": tensor, "global_step": n,
        "LR_Scheduler": {...}}``."""
        from .lr import LRScheduler

        out = {"LR_Scheduler": {}}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        for p in self._parameter_list:
            name = self._param_names[id(p)]
            for k, v in self._accumulators.get(id(p), {}).items():
                out[f"{name}.{k}"] = v
        out["global_step"] = self._step_count
        return out

    def set_state_dict(self, state):
        """Load a :meth:`state_dict`; raises on a key that names no
        accumulator of a parameter here, or on a misshaped tensor."""
        from .lr import LRScheduler

        if isinstance(self._learning_rate, LRScheduler) and \
                state.get("LR_Scheduler"):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        self._step_count = int(state.get("global_step", 0))
        slots = {}
        for p in self._parameter_list:
            st = self._state_for(p)
            for k in st:
                slots[f"{self._param_names[id(p)]}.{k}"] = (st, k)
        for key, v in state.items():
            if key in ("LR_Scheduler", "global_step"):
                continue
            if key not in slots:
                raise KeyError(f"optimizer state {key!r} names no "
                               "accumulator of this optimizer")
            st, k = slots[key]
            if tuple(v.shape) != tuple(st[k].shape):
                raise ValueError(f"optimizer state {key!r}: shape "
                                 f"{tuple(v.shape)}, expected "
                                 f"{tuple(st[k].shape)}")
            st[k] = v.to(device=st[k].device, dtype=st[k].dtype).clone()

    # -------- core --------
    def _update(self, param, grad, state, lr):
        raise NotImplementedError

    def _update_raw(self, p, param, grad, state, lr):
        return self._update(param, grad, state, lr)

    def _decay_exempt(self, p):
        """Decay skips a parameter flagged ``no_weight_decay``."""
        return getattr(p, "no_weight_decay", False)

    def _apply(self, params_grads):
        """Update each parameter in place from its (clipped) gradient at
        this step's learning rate, an f32 scalar as in the JAX step."""
        lr = torch.tensor(self.get_lr(), dtype=torch.float32,
                          device=self.device)
        with torch.no_grad():
            for p, g in params_grads:
                if g is None:
                    continue
                self._cur_wd = (0.0 if self._decay_exempt(p)
                                else self._weight_decay)
                new_p, new_state = self._update_raw(
                    p, p.detach(), g, self._state_for(p), lr)
                p.copy_(new_p)
                self._accumulators[id(p)] = new_state

    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        self._apply(params_grads)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None
