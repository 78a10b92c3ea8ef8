"""Learning-rate schedulers, as ``paddle_tpu/optimizer/lr.py``: the base
``LRScheduler`` (``step()`` advances ``last_epoch`` and caches
``last_lr``), ``LinearWarmup`` (a linear ramp that hands over to a wrapped
scheduler or a constant) and ``CosineAnnealingDecay``.  Plain Python
floats; the optimizer reads ``get_lr()`` once per step."""

from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def get_lr(self):
        raise NotImplementedError

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1):
        self.lr_sched = (learning_rate if isinstance(learning_rate,
                                                     LRScheduler) else None)
        self.target = (learning_rate if not isinstance(learning_rate,
                                                       LRScheduler) else None)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return ((self.end_lr - self.start_lr) * self.last_epoch
                    / self.warmup_steps + self.start_lr)
        if self.lr_sched is not None:
            return self.lr_sched.get_lr()
        return self.target

    def step(self, epoch=None):
        if self.lr_sched is not None and self.last_epoch >= self.warmup_steps:
            self.lr_sched.step(epoch)
        super().step(epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
