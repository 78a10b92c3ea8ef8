"""``paddle_tpu/incubate`` (Paddle's ``paddle.incubate``): the fused
functionals and layers (``incubate.nn``), the masked softmaxes,
``identity_loss``, and the ``LookAhead`` and ``ModelAverage`` wrappers
over the port's optimizers (``:62-149``).  ``graph_send_recv``,
``graph_khop_sampler`` and the ``segment_*`` reductions wait for
``geometric/`` (ROADMAP.md); ``incubate.autograd`` holds the
``Jacobian``/``Hessian`` objects over ``autograd``."""

from __future__ import annotations

import contextlib

import torch

from . import autograd, nn
from ..ops.softmax_mask_fuse import (softmax_mask_fuse,
                                     softmax_mask_fuse_upper_triangle)


def identity_loss(x, reduction="none"):
    """``x`` marked as a loss: summed (``"sum"`` or 0), averaged
    (``"mean"`` or 1) or as it is."""
    if reduction in (0, "sum"):
        return x.sum()
    if reduction in (1, "mean"):
        return x.mean()
    return x


class LookAhead:
    """Lookahead (``:80-110``): ``k`` steps of the inner optimizer, then
    the slow weights move ``alpha`` of the way to the fast ones and the
    parameters take them (in place, in the parameter's dtype); the slow
    weights start as the parameters before the first step."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._slow = None
        self._steps = 0

    def _params(self):
        return [p for p in self.inner._parameter_list if p.requires_grad]

    @torch.no_grad()
    def step(self):
        if self._slow is None:
            self._slow = [p.detach().clone() for p in self._params()]
        self.inner.step()
        self._steps += 1
        if self._steps % self.k == 0:
            for p, slow in zip(self._params(), self._slow):
                p.copy_(slow + self.alpha * (p - slow))
            self._slow = [p.detach().clone() for p in self._params()]

    def clear_grad(self, *a, **k):
        self.inner.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ModelAverage:
    """The running average of the parameters (``:113-149``): ``step``
    adds each parameter to an f32 sum; ``apply`` puts ``sum / steps``
    into the parameters (in their dtype) and, with ``need_restore``,
    returns a context that restores them on exit; ``restore`` puts the
    saved values back.  The window arguments are accepted and unused, as
    in JAX."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000):
        self._params = [p for p in (parameters or []) if p.requires_grad]
        self._acc = [torch.zeros_like(p, dtype=torch.float32)
                     for p in self._params]
        self._n = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        for a, p in zip(self._acc, self._params):
            a.add_(p.to(torch.float32))
        self._n += 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = [p.detach().clone() for p in self._params]
        for p, a in zip(self._params, self._acc):
            p.copy_(a / max(self._n, 1))
        if not need_restore:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def restoring():
            try:
                yield
            finally:
                self.restore()

        return restoring()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is not None:
            for p, b in zip(self._params, self._backup):
                p.copy_(b)
            self._backup = None


__all__ = ["LookAhead", "ModelAverage", "identity_loss", "nn",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]
