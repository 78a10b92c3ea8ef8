"""Dynamic loss scaling, the counterpart of ``paddle_tpu/amp/grad_scaler.py``.

The scale and the good/bad step counters are tensors on the scaler's
``device`` (``cuda`` unless the caller passes ``"cpu"``): an f32 scale
and int32 counters, as the JAX ``TrainStep`` carries them through its
program.  ``jit.TrainStep(scaler=)`` scales, unscales, skips and updates
on the device without reading any of them on the host
(:meth:`AmpScaler.unscale_grads` and :meth:`AmpScaler._advance`).  The
eager API (:meth:`scale`, :meth:`unscale_`, :meth:`step`,
:meth:`update`, :meth:`minimize`) keeps JAX's: :meth:`step` reads
whether a gradient overflowed on the host and skips ``optimizer.step()``
then, as ``grad_scaler.py:79-86``.
"""

from __future__ import annotations

import enum

import torch

from ..device import resolve_device


class OptimizerState(enum.Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**16, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True,
                 device=None):
        self.device = resolve_device(device)
        self._enable = enable
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32, device=self.device)
        self._good_steps = self._count(0)
        self._bad_steps = self._count(0)
        self._found_inf = torch.zeros((), dtype=torch.bool, device=self.device)
        self._state = OptimizerState.INIT

    def _count(self, n):
        return torch.tensor(int(n), dtype=torch.int32, device=self.device)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale.to(var.dtype)

    def unscale_grads(self, params):
        """Each gradient of ``params`` times ``1 / scale`` in f32, rounded
        back to the gradient's dtype, in place of the gradient; returns
        whether any of them is not finite, a bool tensor on the device
        (``train_step.py:308-318``)."""
        inv = 1.0 / self._scale
        found = torch.zeros((), dtype=torch.bool, device=self.device)
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    continue
                g32 = p.grad.to(torch.float32) * inv
                found = found | ~torch.isfinite(g32).all()
                p.grad = g32.to(p.grad.dtype)
        return found

    def unscale_(self, optimizer):
        if not self._enable:
            return
        self._found_inf = self.unscale_grads(optimizer._parameter_list)
        self._state = OptimizerState.UNSCALED

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._state != OptimizerState.UNSCALED:
            self.unscale_(optimizer)
        if not bool(self._found_inf):
            optimizer.step()
        self._state = OptimizerState.STEPPED

    def _advance(self, found_inf):
        """The counters and the scale after a step whose gradients
        overflowed where ``found_inf`` (a bool tensor) holds, on the
        device: ``decr_every`` bad steps in a row scale by
        ``decr_ratio`` (not below 1), ``incr_every`` good ones by
        ``incr_ratio``; without dynamic scaling only the counters move
        (``train_step.py:347-360``)."""
        bad = torch.where(found_inf, self._bad_steps + 1, 0)
        good = torch.where(found_inf, 0, self._good_steps + 1)
        if self._dynamic:
            dec = found_inf & (bad >= self._decr_every)
            inc = ~found_inf & (good >= self._incr_every)
            # in place: the tensors outlive the step (a replayed CUDA
            # graph reads and writes the same storage every time)
            self._scale.copy_(torch.where(
                dec, torch.clamp(self._scale * self._decr_ratio, min=1.0),
                torch.where(inc, self._scale * self._incr_ratio,
                            self._scale)))
            good = torch.where(inc, 0, good)
            bad = torch.where(dec, 0, bad)
        self._good_steps.copy_(good)
        self._bad_steps.copy_(bad)

    def update(self):
        if self._enable and self._dynamic:
            self._advance(self._found_inf)
        self._state = OptimizerState.INIT

    def minimize(self, optimizer, loss):
        self.scale(loss).backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    # -------- introspection / state --------
    def get_loss_scaling(self):
        """The scale now: a copy, which later steps leave as it is."""
        return self._scale.clone()

    def set_init_loss_scaling(self, v):
        # written into the scale's own storage, as every other setter of
        # the scale and the counters: a captured ``TrainStep.many`` pack
        # reads the addresses it recorded
        self._scale.fill_(float(v))

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, v):
        self._incr_ratio = v

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, v):
        self._decr_ratio = v

    def get_incr_every_n_steps(self):
        return self._incr_every

    def set_incr_every_n_steps(self, v):
        self._incr_every = v

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every

    def set_decr_every_n_nan_or_inf(self, v):
        self._decr_every = v

    def state_dict(self):
        return {
            "scale": self._scale.item(),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "incr_count": int(self._good_steps.item()),
            "decr_count": int(self._bad_steps.item()),
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, state):
        if "scale" in state:
            self.set_init_loss_scaling(state["scale"])
        self._incr_ratio = state.get("incr_ratio", self._incr_ratio)
        self._decr_ratio = state.get("decr_ratio", self._decr_ratio)
        self._incr_every = state.get("incr_every_n_steps", self._incr_every)
        self._decr_every = state.get("decr_every_n_nan_or_inf",
                                     self._decr_every)
        self._good_steps.fill_(int(state.get("incr_count", 0)))
        self._bad_steps.fill_(int(state.get("decr_count", 0)))


class GradScaler(AmpScaler):
    pass
