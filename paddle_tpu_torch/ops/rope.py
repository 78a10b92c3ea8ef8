"""Rotary position embedding, neox (half-split) style, as
``paddle_tpu/ops/rope.py``.  Layout [batch, seq, heads, head_dim]; sin
and cos are computed in f32 from per-row position ids and the rotation
runs in f32 before the cast back to the input dtype."""

from __future__ import annotations

import torch


def rope_sin_cos(position_ids, head_dim, base=10000.0):
    """f32 (sin, cos) of shape [..., head_dim // 2] for integer
    ``position_ids`` [...]."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32,
        device=position_ids.device) / head_dim))
    freqs = position_ids.to(torch.float32)[..., None] * inv_freq
    return torch.sin(freqs), torch.cos(freqs)


def apply_rotary_emb(x, position_ids, base=10000.0):
    """Rotate ``x`` [B, S, H, D] at ``position_ids`` [B, S] (or [S])."""
    d = x.shape[-1]
    if position_ids.dim() == 1:
        position_ids = position_ids[None, :]
    sin, cos = rope_sin_cos(position_ids, d, base)
    sin = sin[:, :, None, :]                     # [B|1, S, 1, D/2]
    cos = cos[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
