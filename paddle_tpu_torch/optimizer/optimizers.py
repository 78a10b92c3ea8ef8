"""The optimizers of ``paddle_tpu/optimizer/optimizers.py``: SGD,
Momentum, Adagrad, Adadelta, RMSProp, Adam, AdamW, Adamax, Lamb, Rprop,
ASGD, NAdam and RAdam.

Each ``_update`` carries the JAX update over term for term, in the same
order and dtypes.  ``_adam_math``: f32 moments, ``beta1_pow`` /
``beta2_pow`` as f32 scalars, the bias-corrected step, decoupled decay
``p * (1 - lr * coeff)`` before it (AdamW) or coupled L2 added to the
gradient (Adam), and under ``multi_precision`` an f32 ``master_weight``
that the update reads and writes, the parameter being its cast.  Master
weights exist where JAX keeps them: Adam, AdamW, Adadelta, NAdam and
RAdam (Adamax, Lamb, Rprop and ASGD accept ``multi_precision`` and, as
in JAX, update from the parameter).  SGD, Momentum, Adagrad and RMSProp
compute in the parameter's dtype, the others in f32.  Coupled L2
(``weight_decay``) is added to the gradient where JAX adds it
(``_apply_l2``).  ``torch.optim`` rounds in other orders and is not
used.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer


def _apply_l2(grad, param, coeff):
    """Coupled L2: ``grad + coeff * param`` (``optimizer.py:220``)."""
    if coeff:
        return grad + coeff * param
    return grad


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)

    def _update(self, param, grad, state, lr):
        grad = _apply_l2(grad, param, self._cur_wd)
        return param - lr * grad, state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p.detach())}

    def _update(self, param, grad, state, lr):
        grad = _apply_l2(grad, param, self._cur_wd)
        v = self._momentum * state["velocity"] + grad
        if self._nesterov:
            update = grad + self._momentum * v
        else:
            update = v
        return param - lr * update, {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p.detach(), self._init_acc)}

    def _update(self, param, grad, state, lr):
        grad = _apply_l2(grad, param, self._cur_wd)
        m = state["moment"] + grad.square()
        return param - lr * grad / (torch.sqrt(m) + self._epsilon), \
            {"moment": m}


class Adadelta(Optimizer):
    """Step size from the ratio of the running RMS of updates to the
    running RMS of gradients."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)
        self._epsilon = epsilon
        self._rho = rho
        self._multi_precision = multi_precision

    def _init_state(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        st = {"avg_squared_grad": torch.zeros(p.shape, **f32),
              "avg_squared_update": torch.zeros(p.shape, **f32)}
        if self._multi_precision and p.dtype != torch.float32:
            st["master_weight"] = p.detach().to(torch.float32)
        return st

    def _update(self, param, grad, state, lr):
        master = state.get("master_weight", param)
        g32 = _apply_l2(grad, master, self._cur_wd).to(torch.float32)
        eg = self._rho * state["avg_squared_grad"] \
            + (1 - self._rho) * g32.square()
        upd = -torch.sqrt((state["avg_squared_update"] + self._epsilon)
                          / (eg + self._epsilon)) * g32
        eu = self._rho * state["avg_squared_update"] \
            + (1 - self._rho) * upd.square()
        p32 = master.to(torch.float32) + lr * upd
        new_state = {"avg_squared_grad": eg, "avg_squared_update": eu}
        if "master_weight" in state:
            new_state["master_weight"] = p32
        return p32.to(param.dtype), new_state


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, p):
        st = {"mean_square": torch.zeros_like(p.detach()),
              "velocity": torch.zeros_like(p.detach())}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p.detach())
        return st

    def _update(self, param, grad, state, lr):
        grad = _apply_l2(grad, param, self._cur_wd)
        ms = self._rho * state["mean_square"] \
            + (1 - self._rho) * grad.square()
        new_state = dict(state, mean_square=ms)
        if self._centered:
            mg = self._rho * state["mean_grad"] + (1 - self._rho) * grad
            denom = torch.sqrt(ms - mg.square() + self._epsilon)
            new_state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        v = self._momentum * state["velocity"] + lr * grad / denom
        new_state["velocity"] = v
        return param - v, new_state


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


class Adamax(Adam):
    def _init_state(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        return {"moment": torch.zeros(p.shape, **f32),
                "inf_norm": torch.zeros(p.shape, **f32),
                "beta1_pow": torch.ones((), **f32)}

    def _update(self, param, grad, state, lr):
        g32 = _apply_l2(grad.to(torch.float32), param.to(torch.float32),
                        self._cur_wd)
        b1p = state["beta1_pow"] * self._beta1
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * state["inf_norm"],
                          g32.abs() + 1e-12)
        p32 = param.to(torch.float32) - (lr / (1 - b1p)) * m / (
            u + self._epsilon)
        return p32.to(param.dtype), dict(state, moment=m, inf_norm=u,
                                         beta1_pow=b1p)


class Lamb(Optimizer):
    """Layer-wise trust ratio ``|w| / |update|`` (1 where either norm
    is 0) over Adam's step plus ``lamb_weight_decay * w``; the decay is
    0 for a parameter flagged ``no_weight_decay`` or for which
    ``exclude_from_weight_decay_fn(param)`` is true."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, device=None):
        super().__init__(learning_rate, parameters, None, grad_clip, device)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._weight_decay = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_exempt(self, p):
        if super()._decay_exempt(p):
            return True
        return self._exclude_fn is not None and bool(self._exclude_fn(p))

    def _init_state(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros(p.shape, **f32),
                "moment2": torch.zeros(p.shape, **f32),
                "beta1_pow": torch.ones((), **f32),
                "beta2_pow": torch.ones((), **f32)}

    def _update(self, param, grad, state, lr):
        p32 = param.to(torch.float32)
        g32 = grad.to(torch.float32)
        b1p = state["beta1_pow"] * self._beta1
        b2p = state["beta2_pow"] * self._beta2
        m1 = self._beta1 * state["moment1"] + (1 - self._beta1) * g32
        m2 = self._beta2 * state["moment2"] + (1 - self._beta2) * \
            g32.square()
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        r = m1_hat / (torch.sqrt(m2_hat) + self._epsilon)
        update = r + self._cur_wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        p32 = p32 - lr * trust * update
        return p32.to(param.dtype), dict(state, moment1=m1, moment2=m2,
                                         beta1_pow=b1p, beta2_pow=b2p)


class Rprop(Optimizer):
    """Resilient backprop: per-element step sizes grown by ``etas[1]``
    where the gradient keeps its sign, shrunk by ``etas[0]`` where it
    flips (and that element skips its update), clipped to
    ``learning_rate_range``; the first steps start at the learning
    rate."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, device=None):
        super().__init__(learning_rate, parameters, None, grad_clip, device)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _init_state(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        return {"prev_grad": torch.zeros(p.shape, **f32),
                "step_size": torch.full(p.shape, float(self.get_lr()),
                                        **f32)}

    def _update(self, param, grad, state, lr):
        g32 = grad.to(torch.float32)
        sign = torch.sign(g32 * state["prev_grad"])
        step = torch.where(sign > 0, state["step_size"] * self._eta_pos,
                           torch.where(sign < 0,
                                       state["step_size"] * self._eta_neg,
                                       state["step_size"]))
        step = torch.clamp(step, self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g32)
        p32 = param.to(torch.float32) - torch.sign(g_eff) * step
        return p32.to(param.dtype), {"prev_grad": g_eff, "step_size": step}


class ASGD(Optimizer):
    """Averaged SGD: each step applies the mean of the last
    ``batch_num`` gradients, a running sum ``d`` and a ring ``y`` of the
    gradients in it, indexed on the device by the f32 step count."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)
        self._batch_num = max(1, int(batch_num))

    def _init_state(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        return {"d": torch.zeros(p.shape, **f32),
                "y": torch.zeros((self._batch_num,) + tuple(p.shape), **f32),
                "step": torch.zeros((), **f32)}

    def _update(self, param, grad, state, lr):
        g32 = _apply_l2(grad, param, self._cur_wd).to(torch.float32)
        n = state["y"].shape[0]
        idx = torch.remainder(state["step"], float(n)).to(torch.int64)
        oldest = state["y"].index_select(0, idx.view(1))[0]
        d = state["d"] - oldest + g32
        y = state["y"].index_copy(0, idx.view(1), g32[None])
        count = torch.clamp(state["step"] + 1.0, max=float(n))
        p32 = param.to(torch.float32) - lr * d / count
        return p32.to(param.dtype), {"d": d, "y": y,
                                     "step": state["step"] + 1.0}


class NAdam(Adam):
    """Adam with Nesterov momentum (``momentum_decay`` psi), with an
    explicit f32 step count, as JAX."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 device=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, device)
        self._psi = momentum_decay

    def _init_state(self, p):
        st = super()._init_state(p)
        f32 = dict(dtype=torch.float32, device=p.device)
        st["mu_product"] = torch.ones((), **f32)
        st["step"] = torch.zeros((), **f32)
        return st

    def _update(self, param, grad, state, lr):
        p32 = state.get("master_weight", param).to(torch.float32)
        g32 = grad.to(torch.float32)
        if self._cur_wd:
            g32 = g32 + self._cur_wd * p32
        step = state["step"] + 1.0
        mu_t = self._beta1 * (1 - 0.5 * 0.96 ** (step * self._psi))
        mu_t1 = self._beta1 * (1 - 0.5 * 0.96 ** ((step + 1) * self._psi))
        mu_prod = state["mu_product"] * mu_t
        m1 = self._beta1 * state["moment1"] + (1 - self._beta1) * g32
        m2 = self._beta2 * state["moment2"] + (1 - self._beta2) * \
            g32.square()
        b2p = state["beta2_pow"] * self._beta2
        m2_hat = m2 / (1 - b2p)
        m1_bar = (mu_t1 * m1 / (1 - mu_prod * mu_t1)
                  + (1 - mu_t) * g32 / (1 - mu_prod))
        p32 = p32 - lr * m1_bar / (torch.sqrt(m2_hat) + self._epsilon)
        new_state = dict(
            state, moment1=m1, moment2=m2,
            beta1_pow=state["beta1_pow"] * self._beta1, beta2_pow=b2p,
            mu_product=mu_prod, step=step)
        if "master_weight" in state:
            new_state["master_weight"] = p32
        return p32.to(param.dtype), new_state


class RAdam(Adam):
    """Rectified Adam, with an explicit f32 step count, as JAX."""

    def _init_state(self, p):
        st = super()._init_state(p)
        st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
        return st

    def _update(self, param, grad, state, lr):
        p32 = state.get("master_weight", param).to(torch.float32)
        g32 = grad.to(torch.float32)
        if self._cur_wd:
            g32 = g32 + self._cur_wd * p32
        b1p = state["beta1_pow"] * self._beta1
        b2p = state["beta2_pow"] * self._beta2
        m1 = self._beta1 * state["moment1"] + (1 - self._beta1) * g32
        m2 = self._beta2 * state["moment2"] + (1 - self._beta2) * \
            g32.square()
        step = state["step"] + 1.0
        rho_inf = 2.0 / (1 - self._beta2) - 1.0
        rho_t = rho_inf - 2.0 * step * b2p / (1 - b2p)
        m1_hat = m1 / (1 - b1p)
        rect = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                          / torch.clamp((rho_inf - 4) * (rho_inf - 2)
                                        * rho_t, min=1e-12))
        adaptive = rect * m1_hat / (torch.sqrt(m2 / (1 - b2p))
                                    + self._epsilon)
        upd = torch.where(rho_t > 5.0, adaptive, m1_hat)
        p32 = p32 - lr * upd
        new_state = dict(state, moment1=m1, moment2=m2, beta1_pow=b1p,
                         beta2_pow=b2p, step=step)
        if "master_weight" in state:
            new_state["master_weight"] = p32
        return p32.to(param.dtype), new_state
