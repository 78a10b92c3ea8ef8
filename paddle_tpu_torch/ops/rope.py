"""Rotary position embedding, as ``paddle_tpu/ops/rope.py``
(``rope_arrays`` and ``apply_rotary_emb``, ``:18-75``).  Layout
[batch, seq, heads, head_dim].

The tables are computed in f32 from the positions (``arange(S)``, or
per-row ``position_ids``), or taken from the caller as ``sin``/``cos``
in any of JAX's forms: ``[S, D/2]``, ``[B, S, D/2]``, paddle's
``[1, S, 1, D]`` or any full-``D`` table (squeezed, then cut to its
first half).  NeoX rotates the two halves of the head (``neox=True``),
GPT-J the interleaved pairs (``neox=False``).  The rotation runs in f32
and the result is cast back to the input dtype.
"""

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


def _to_bs1d(t):
    """A half table as [B or 1, S, 1, D/2] (the head axis broadcast)."""
    if t.dim() == 2:                              # [S, D/2]
        return t[None, :, None, :]
    if t.dim() == 3:                              # [B, S, D/2]
        return t[:, :, None, :]
    return t


def apply_rotary_emb(x, sin=None, cos=None, position_ids=None, neox=True,
                     base=10000.0):
    """Rotate ``x`` [B, S, H, D] by caller-given ``sin``/``cos`` tables,
    or by tables made at ``position_ids`` ([B, S] or [S]; default
    ``arange(S)``) with ``base``."""
    s, d = x.shape[1], x.shape[-1]
    if sin is None or cos is None:
        pos = position_ids if position_ids is not None else torch.arange(
            s, device=x.device)
        sin, cos = rope_sin_cos(pos, d, base)
    else:
        sin = sin.squeeze().to(torch.float32)
        cos = cos.squeeze().to(torch.float32)
        if sin.shape[-1] == d:                    # full tables: take half
            sin, cos = sin[..., : d // 2], cos[..., : d // 2]
    sin, cos = _to_bs1d(sin), _to_bs1d(cos)
    xf = x.to(torch.float32)
    if neox:
        x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xf.shape)
    return out.to(x.dtype)
