"""Adam and AdamW, as ``paddle_tpu/optimizer/optimizers.py``.

``_adam_math`` carries the JAX update over term for term, in the same
order: f32 moments, ``beta1_pow`` / ``beta2_pow`` as f32 scalars, the
bias-corrected step, decoupled decay ``p * (1 - lr * coeff)`` before it
(AdamW) or coupled L2 added to the gradient (Adam), and under
``multi_precision`` an f32 ``master_weight`` that the update reads and
writes, the parameter being its cast.  ``torch.optim.AdamW`` rounds in
another order and is not used.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _init_state(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        st = {"moment1": torch.zeros(p.shape, **f32),
              "moment2": torch.zeros(p.shape, **f32),
              "beta1_pow": torch.ones((), **f32),
              "beta2_pow": torch.ones((), **f32)}
        if self._multi_precision and p.dtype != torch.float32:
            st["master_weight"] = p.detach().to(torch.float32)
        return st

    def _adam_math(self, param, grad, state, lr, decoupled_wd=0.0,
                   coupled_l2=0.0):
        master = state.get("master_weight", param)
        p32 = master.to(torch.float32)
        g32 = grad.to(torch.float32)
        if coupled_l2:
            g32 = g32 + coupled_l2 * p32
        b1p = state["beta1_pow"] * self._beta1
        b2p = state["beta2_pow"] * self._beta2
        m1 = self._beta1 * state["moment1"] + (1 - self._beta1) * g32
        m2 = self._beta2 * state["moment2"] + (1 - self._beta2) * g32.square()
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        if decoupled_wd:
            p32 = p32 * (1 - lr * decoupled_wd)
        p32 = p32 - lr * m1_hat / (torch.sqrt(m2_hat) + self._epsilon)
        new_state = dict(state, moment1=m1, moment2=m2, beta1_pow=b1p,
                         beta2_pow=b2p)
        if "master_weight" in state:
            new_state["master_weight"] = p32
        return p32.to(param.dtype), new_state

    def _update(self, param, grad, state, lr):
        return self._adam_math(param, grad, state, lr,
                               coupled_l2=self._cur_wd)


class AdamW(Adam):
    """Adam with decoupled decay.  ``lr_ratio(p)``, where given, scales
    the step's learning rate for parameter ``p`` (the decay too, as in
    the JAX version, which multiplies the lr before both)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, device=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision, device)
        self._coeff = float(weight_decay)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_for(self, p):
        if self._decay_exempt(p):
            return 0.0
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._param_names[id(p)]):
            return 0.0
        return self._coeff

    def _update_raw(self, p, param, grad, state, lr):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        return self._adam_math(param, grad, state, lr,
                               decoupled_wd=self._decay_for(p))
