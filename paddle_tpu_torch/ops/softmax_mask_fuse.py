"""Masked softmax, as ``paddle_tpu/ops/softmax_mask_fuse.py``:
``softmax(x + mask)`` over the last axis, and the causal form that sets
every key above the diagonal (offset by ``Sk - Sq``) to -1e30 first.
Plain torch, as the JAX package leaves both to XLA outside any Pallas
kernel; each softmax runs in x's dtype, as ``jax.nn.softmax``."""

from __future__ import annotations

import torch


def softmax_mask_fuse(x, mask):
    return torch.softmax(x + mask, dim=-1)


def softmax_mask_fuse_upper_triangle(x):
    s_q, s_k = x.shape[-2], x.shape[-1]
    causal = torch.ones((s_q, s_k), dtype=torch.bool,
                        device=x.device).tril(s_k - s_q)
    return torch.softmax(torch.where(causal, x, -1e30), dim=-1)
