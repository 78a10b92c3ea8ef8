"""Optimizer base, as ``paddle_tpu/optimizer/optimizer.py``.

Every optimizer's math is one array function,
``_update(param, grad, state, lr) -> (new_param, new_state)``, the JAX
package's design carried over: :meth:`Optimizer.step` (which
``jit.TrainStep`` calls) applies it parameter by parameter.  The results
are written back in place (``param.copy_``), so the parameters keep
their storage and their dtype; the per-parameter state is a dict of
tensors on the parameter's device, each keeping its dtype.

The optimizer lives on ``device`` (``cuda`` unless the caller passes
``"cpu"``) and refuses parameters elsewhere.  ``parameters`` may be
tensors or ``(name, tensor)`` pairs (``model.named_parameters()``); the
names key :meth:`state_dict` as ``"<name>.<accumulator>"``.  In static
mode ``parameters`` may be None: :meth:`minimize` takes them from the
loss's recorded graph (JAX's ``optimizer.py:24-33``).

Every tensor a step reads or writes keeps its storage from step to step,
so a step can be captured in a CUDA graph and replayed
(``jit.TrainStep.many``): the accumulators are updated in place, and the
rate is a persistent f32 tensor per multiplier, filled on the device
before each eager step (and, for a replayed graph, once before the
replay: :meth:`_fill_lrs`), never filled while a stream captures.

Per parameter, as JAX's ``step`` (``optimizer.py:140-190``): the rate is
multiplied by the parameter's ``optimize_attr["learning_rate"]``
(``ParamAttr(learning_rate=)``); a parameter with ``trainable`` False is
not updated; a ``regularizer`` attached through ``ParamAttr`` adds its
gradient term and replaces the optimizer's ``weight_decay`` for it.
``weight_decay`` takes a float or ``L2Decay`` (the coupled L2 of the
update, its ``coeff``) or ``L1Decay`` (a gradient term), as JAX maps
them (``:39-51``).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..regularizer import L2Decay


def _capturing(device):
    """Whether ``device``'s current stream is capturing a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, device=None):
        self.device = resolve_device(device)
        self._param_names = {}
        if parameters is None:
            from ..tensor.logic import in_dynamic_mode

            if in_dynamic_mode():
                raise ValueError("parameters must be provided (dygraph "
                                 "mode)")
            # static mode: minimize() takes them from the loss's graph
            self._parameter_list = None
            parameters = ()
        else:
            self._parameter_list = []
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
        self._regularizer_fn = None
        if weight_decay is None or isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay or 0.0)
        elif isinstance(weight_decay, L2Decay):
            self._weight_decay = weight_decay.coeff
        else:                        # L1Decay: a gradient term
            self._weight_decay = 0.0
            self._regularizer_fn = weight_decay
        self._cur_wd = self._weight_decay
        self._accumulators = {}      # id(param) -> {state name: tensor}
        self._lr_tensors = {}        # multiplier -> persistent f32 rate
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
        for p in self._parameter_list or ():
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
        for p in self._parameter_list or ():
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
            st[k].copy_(v.to(device=st[k].device, dtype=st[k].dtype))

    # -------- core --------
    def _update(self, param, grad, state, lr):
        raise NotImplementedError

    def _update_raw(self, p, param, grad, state, lr):
        return self._update(param, grad, state, lr)

    def _decay_exempt(self, p):
        """Decay skips a parameter flagged ``no_weight_decay``."""
        return getattr(p, "no_weight_decay", False)

    def _coupled_wd_for(self, p):
        """The coupled L2 coefficient for ``p``: none where a
        ``ParamAttr`` regularizer replaces it or ``p`` is exempt."""
        if getattr(p, "regularizer", None) is not None or \
                self._decay_exempt(p):
            return 0.0
        return self._weight_decay

    def _regularized_grad(self, p, grad):
        """``grad`` plus the winning gradient-term regularizer: the
        parameter's own, else (unless exempt) the optimizer's L1."""
        per_param = getattr(p, "regularizer", None)
        if per_param is not None:
            return grad + per_param(p.detach())
        if self._regularizer_fn is not None and not self._decay_exempt(p):
            return grad + self._regularizer_fn(p.detach())
        return grad

    def _lr_for(self, p, lrs):
        """This step's f32 rate times ``p``'s multiplier (the product
        taken in Python, as JAX's), one persistent tensor per multiplier,
        filled on the device once a step (not while a stream captures: a
        replayed graph reads what :meth:`_fill_lrs` wrote)."""
        mult = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
        if mult not in lrs:
            t = self._lr_tensors.get(mult)
            if t is None:
                t = self._lr_tensors[mult] = torch.empty(
                    (), dtype=torch.float32, device=self.device)
            if not _capturing(self.device):
                t.fill_(self.get_lr() * mult)
            lrs[mult] = t
        return lrs[mult]

    def _fill_lrs(self):
        """Write this step's rate into every rate tensor (before a
        replayed graph: the rate is read once for the pack)."""
        lr = self.get_lr()
        for mult, t in self._lr_tensors.items():
            t.fill_(lr * mult)

    def _apply(self, params_grads, skip=None):
        """Update each parameter in place from its (clipped) gradient at
        this step's learning rate, an f32 scalar as in the JAX step.
        Where the bool tensor ``skip`` holds, each parameter and its
        state keep their values (a loss-scaled step whose gradients
        overflowed, ``paddle_tpu/jit/train_step.py:335-341``), decided on
        the device."""
        lrs = {}
        with torch.no_grad():
            for p, g in params_grads:
                if g is None:
                    continue
                self._cur_wd = self._coupled_wd_for(p)
                g = self._regularized_grad(p, g)
                state = self._state_for(p)
                new_p, new_state = self._update_raw(
                    p, p.detach(), g, state, self._lr_for(p, lrs))
                if skip is not None:
                    new_p = torch.where(skip, p, new_p)
                    new_state = {k: torch.where(skip, state[k], v)
                                 for k, v in new_state.items()}
                p.copy_(new_p)
                # in place, each accumulator in its dtype (as JAX's
                # _update_for): its storage outlives the step
                for k, v in new_state.items():
                    if k in state:
                        state[k].copy_(v)
                    else:
                        state[k] = v

    def step(self, skip=None):
        """Clip, count the step and update (see :meth:`_apply` for
        ``skip``, which ``jit.TrainStep`` passes under a loss scaler)."""
        params_grads = [(p, p.grad) for p in self._parameter_list or ()
                        if p.requires_grad and p.grad is not None
                        and getattr(p, "trainable", True)]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        self._apply(params_grads, skip)

    def clear_grad(self):
        for p in self._parameter_list or ():
            p.grad = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """A static loss (JAX's ``optimizer.py:200-209``): register the
        training op on the loss's program, each ``Executor.run`` of it
        steps -> (None, [(param, grad)]).  An eager loss: backward, then
        :meth:`step` -> (None, None)."""
        from ..static import graph

        if graph.is_symbolic(loss):
            return graph.register_minimize(self, loss, parameters=parameters,
                                           no_grad_set=no_grad_set)
        loss.backward()
        self.step()
        return None, None
