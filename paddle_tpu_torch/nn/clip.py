"""Gradient clipping by the global norm, as ``paddle_tpu/nn/clip.py``
``ClipGradByGlobalNorm``: one norm over every gradient, taken in f32,
then ``scale = clip_norm / max(norm, clip_norm)`` applied to each
gradient in f32 and cast back to its dtype."""

from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

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
