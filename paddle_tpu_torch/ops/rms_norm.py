"""RMSNorm forward: ``y = x * rsqrt(mean(x^2) + eps) * w`` over the last
dim, statistics in f32, y in x's dtype.

Replaces the Pallas kernel ``_rms_fwd_kernel`` / ``_rms_fwd_call``
(``paddle_tpu/ops/pallas/norms.py:173`` and ``:220``), forward only and
returning y alone (its ``rstd`` output feeds a backward that is not
ported yet).  On the card this is a Triton kernel, one program per row
with ``BLOCK_H`` the next power of two >= H: the row is read once,
reduced in registers and written once.  That is a byte-bound function —
2 * N * H * itemsize bytes plus the weight, against a few operations per
element — so the least time the card can take is those bytes over
3.35 TB/s; one program per row keeps every read and write coalesced and
touches no byte twice, which is all a memory-bound row reduction needs.

:func:`rms_norm` takes the plain PyTorch version for a CPU tensor, the
kernel for a CUDA tensor, and raises for anything else.
"""

from __future__ import annotations

import torch

#: ``triton.language``, bound at the first launch (triton is imported
#: only when a kernel is launched, so this module imports without it)
tl = None
_KERNEL = None


def rms_norm_plain(x, weight, eps=1e-6):
    """The plain PyTorch twin of the kernel (same f32 arithmetic)."""
    xf = x.to(torch.float32)
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * rstd * weight.to(torch.float32)).to(x.dtype)


def _rms_fwd(X, W, Y, H, stride_x, stride_y, eps, BLOCK_H: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < H
    x = tl.load(X + row * stride_x + cols, mask=mask,
                other=0.0).to(tl.float32)
    rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / H + eps)
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(Y + row * stride_y + cols,
             (x * rstd * w).to(Y.dtype.element_ty), mask=mask)


def _kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl
        _KERNEL = triton.jit(_rms_fwd)
    return _KERNEL


def rms_norm_kernel(x, weight, eps=1e-6):
    """Launch the Triton kernel on CUDA tensors (raises on anything it
    does not take)."""
    if not (x.is_cuda and weight.is_cuda and x.device == weight.device):
        raise ValueError("rms_norm kernel: x and weight must share one "
                         "CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rms_norm kernel: unsupported dtype {x.dtype}")
    h = x.shape[-1]
    if weight.shape != (h,):
        raise ValueError(f"rms_norm kernel: weight {tuple(weight.shape)} "
                         f"does not match hidden size {h}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel: inputs must be contiguous")
    x2 = x.view(-1, h)
    y = torch.empty_like(x2)
    if x2.shape[0]:
        block_h = 1 << max(0, h - 1).bit_length()
        _kernel()[(x2.shape[0],)](
            x2, weight, y, h, x2.stride(0), y.stride(0), float(eps),
            BLOCK_H=block_h, num_warps=8 if block_h >= 2048 else 4)
        rms_norm.launches += 1
    return y.view(x.shape)


def rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last dim: the Triton kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type == "cuda":
        return rms_norm_kernel(x, weight, eps)
    raise ValueError(f"rms_norm: unsupported device {x.device}")


rms_norm.launches = 0
