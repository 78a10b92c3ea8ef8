"""Gradient clipping, the counterparts of ``paddle_tpu/nn/clip.py:22-105``.

``ClipGradByValue`` clips each gradient to ``[min, max]``;
``ClipGradByNorm`` scales each gradient by ``min(clip_norm / max(norm,
1e-12), 1)`` of its own norm; ``ClipGradByGlobalNorm`` takes one norm
over every gradient in f32, then ``scale = clip_norm / max(norm,
clip_norm)`` applied to each gradient in f32 and cast back to its dtype
(``group_name`` and ``auto_skip_clip`` are accepted; JAX stores the
first and ignores the second).  ``clip_grad_norm_`` and
``clip_grad_value_`` (``:83-110``) act on the parameters' ``.grad`` in
place."""

from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                norm = torch.linalg.vector_norm(g.reshape(-1))
                g = g * torch.clamp(self.clip_norm / torch.clamp(
                    norm, min=1e-12), max=1.0)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads):
        """The f32 global norm of ``grads`` (a 0-dim tensor), summed in
        the order given."""
        sq = [g.to(torch.float32).square().sum() for g in grads]
        return torch.sqrt(sum(sq[1:], sq[0]))

    def __call__(self, params_grads):
        """``[(param, grad)]`` -> the same list with clipped grads."""
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        scale = self.clip_norm / torch.clamp(self.global_norm(grads),
                                             min=self.clip_norm)
        return [(p, None if g is None else
                 (g.to(torch.float32) * scale).to(g.dtype))
                for p, g in params_grads]


def _with_grads(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [p for p in parameters if p.grad is not None]


def total_norm(grads, norm_type):
    """The ``norm_type`` norm over every gradient of ``grads``."""
    if norm_type == float("inf"):
        return torch.stack([g.abs().max() for g in grads]).max()
    return torch.stack([(g.abs() ** norm_type).sum()
                        for g in grads]).sum() ** (1.0 / norm_type)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """The total ``norm_type`` norm of the gradients; each gradient
    scaled in place by ``min(max_norm / max(total, 1e-6), 1)``
    (``nn.utils.clip_grad_norm_`` divides by ``total + 1e-6``, as JAX's
    two do)."""
    params = _with_grads(parameters)
    if not params:
        return torch.zeros(())
    total = total_norm([p.grad for p in params], norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p in params:
        p.grad.mul_(scale)
    return total


def clip_grad_value_(parameters, clip_value):
    for p in _with_grads(parameters):
        p.grad.clamp_(-clip_value, clip_value)
