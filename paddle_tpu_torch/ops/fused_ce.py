"""Chunked fused linear + softmax cross-entropy over the vocabulary, the
counterpart of ``paddle_tpu/ops/fused_ce.py``.

The LM-head product and the cross-entropy are evaluated one row chunk at
a time, so the ``[N, vocab]`` f32 logits never exist whole: the forward
keeps one ``[chunk, vocab]`` tile live, saves only its inputs, and the
backward recomputes each chunk's logits (the JAX version's
``jax.checkpoint`` on the ``lax.scan`` body).  The weight gradient
accumulates across chunks in f32.  The chunks are ``chunk_rows`` rows
each and the last may be shorter, so no row is padded (the JAX version's
``lax.scan`` needs equal chunks and pads instead).

Plain torch: the products are cuBLAS matmuls (the JAX package leaves
them to XLA, outside any Pallas kernel).  The logits and the weight
gradient's chunk products come out in f32 (see :func:`_mm_f32`); the
softmax, the loss and the logit gradient run in f32, and the logit
gradient is cast to the inputs' dtype for the two backward products.
"""

from __future__ import annotations

import torch


def _mm_f32(a, b):
    """``a @ b`` with an f32 result.  bf16 operands on the card ask
    cuBLAS for the f32 output itself (f32 accumulation, no bf16 rounding
    of the product, as the JAX version's ``preferred_element_type``);
    elsewhere the product is cast."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b).to(torch.float32)


def _logits(h, weight, transpose_weight):
    return _mm_f32(h, weight.t() if transpose_weight else weight)


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, ignore_index, transpose_weight,
                chunk):
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s in range(0, hidden.shape[0], chunk):
            logits = _logits(hidden[s:s + chunk], weight, transpose_weight)
            y = labels[s:s + chunk]
            valid = y != ignore_index
            safe = torch.where(valid, y, torch.zeros_like(y))
            lse = torch.logsumexp(logits, dim=-1)
            true = logits.gather(1, safe[:, None])[:, 0]
            total += torch.where(valid, lse - true,
                                 torch.zeros_like(lse)).sum()
            cnt += valid.sum()
        denom = cnt.clamp(min=1.0)
        ctx.save_for_backward(hidden, weight, labels, denom)
        ctx.cfg = (ignore_index, transpose_weight, chunk)
        return total / denom

    @staticmethod
    def backward(ctx, grad):
        hidden, weight, labels, denom = ctx.saved_tensors
        ignore_index, transpose_weight, chunk = ctx.cfg
        coef = grad / denom
        dh = torch.empty_like(hidden)
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        for s in range(0, hidden.shape[0], chunk):
            h_c = hidden[s:s + chunk]
            y = labels[s:s + chunk]
            valid = y != ignore_index
            safe = torch.where(valid, y, torch.zeros_like(y))
            dlog = torch.softmax(_logits(h_c, weight, transpose_weight), -1)
            dlog[torch.arange(y.shape[0], device=y.device), safe] -= 1.0
            dlog *= (valid.to(torch.float32) * coef)[:, None]
            dlog = dlog.to(hidden.dtype)
            if transpose_weight:            # logits = h @ W^T, W [V, H]
                dh[s:s + chunk] = dlog @ weight
                dw += _mm_f32(dlog.t(), h_c)
            else:                           # logits = h @ W, W [H, V]
                dh[s:s + chunk] = dlog @ weight.t()
                dw += _mm_f32(h_c.t(), dlog)
        return dh, dw.to(weight.dtype), None, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               transpose_weight=False, chunk_rows=2048):
    """Mean CE(softmax(hidden @ weight), labels) over the rows not
    labelled ``ignore_index``, without materialising the logits.
    hidden [N, H]; weight [H, V], or [V, H] with ``transpose_weight=True``
    (the tied-embedding and torch ``Linear`` layout); labels [N]."""
    labels = labels.reshape(-1).to(torch.int64)
    if hidden.shape[0] == 0:
        return torch.zeros((), dtype=torch.float32, device=hidden.device)
    return _FusedLinearCrossEntropy.apply(
        hidden, weight, labels, ignore_index, bool(transpose_weight),
        int(chunk_rows))
