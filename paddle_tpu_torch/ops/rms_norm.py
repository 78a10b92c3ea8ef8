"""RMSNorm, forward and backward: ``y = x * rstd * w`` with
``rstd = rsqrt(mean(x^2) + eps)`` over the last dim, statistics in f32,
y in x's dtype.

Replaces the Pallas kernels ``_rms_fwd_kernel`` (launched by
``_rms_fwd_call``) and ``_rms_bwd_kernel`` (launched by ``_rms_vjp_bwd``),
``paddle_tpu/ops/pallas/norms.py:173, :220`` and ``:181, :257``.  On the
card both are Triton kernels:

* forward: one program per row with ``BLOCK_H`` the next power of two
  >= H; the row is read once, reduced in registers, and y and the f32
  ``rstd`` (which the backward needs) are written once;
* backward: ``dx = rstd * (g*w - xhat * mean(g*w*xhat))`` with
  ``xhat = x * rstd``, and ``dw = sum over rows of g * xhat``.  The TPU
  kernel carries ``dw`` in scratch from one row block to the next; blocks
  on the card run in no order, so each program walks its own run of rows
  and writes an f32 partial ``[n_programs, H]``, and one ``.sum(0)`` over
  that small array adds the partials in a fixed order, so ``dw`` is
  deterministic (as the JAX GroupNorm reduces its partials outside its
  kernel).

Both are bound by bytes: the forward moves ``2 * N * H`` elements plus
the weight, the backward ``3 * N * H`` (x, g in, dx out) plus the weight
and partials, against a few operations per element; every read and
write is a coalesced row, and no byte is touched twice.

:func:`rms_norm` is differentiable (a ``torch.autograd.Function``): the
kernels for CUDA tensors, the plain PyTorch twins for CPU tensors, and
a raise for anything else.  :func:`rms_norm_plain` is the plain forward
differentiated by torch autograd, the reference of the kernel path.
"""

from __future__ import annotations

import torch

#: ``triton.language``, bound at the first launch (triton is imported
#: only when a kernel is launched, so this module imports without it)
tl = None
_KERNELS = {}
_BWD_MAX_PROGRAMS = 512


def rms_norm_fwd_plain(x, weight, eps=1e-6):
    """The plain twin of the forward kernel -> (y, rstd [N] f32)."""
    xf = x.to(torch.float32)
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    y = (xf * rstd * weight.to(torch.float32)).to(x.dtype)
    return y, rstd.reshape(-1)


def rms_norm_plain(x, weight, eps=1e-6):
    """The plain forward (same f32 arithmetic as the kernel)."""
    return rms_norm_fwd_plain(x, weight, eps)[0]


def rms_norm_bwd_plain(x, weight, rstd, g):
    """The plain twin of the backward kernel -> (dx in x's dtype, dw in
    the weight's dtype)."""
    h = x.shape[-1]
    xf = x.reshape(-1, h).to(torch.float32)
    gf = g.reshape(-1, h).to(torch.float32)
    xhat = xf * rstd.reshape(-1, 1)
    gw = gf * weight.to(torch.float32)
    m = (gw * xhat).mean(-1, keepdim=True)
    dx = rstd.reshape(-1, 1) * (gw - xhat * m)
    dw = (gf * xhat).sum(0)
    return dx.to(x.dtype).reshape(x.shape), dw.to(weight.dtype)


def _rms_fwd(X, W, Y, RSTD, H, stride_x, stride_y, eps,
             BLOCK_H: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < H
    x = tl.load(X + row * stride_x + cols, mask=mask,
                other=0.0).to(tl.float32)
    rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / H + eps)
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(Y + row * stride_y + cols,
             (x * rstd * w).to(Y.dtype.element_ty), mask=mask)
    tl.store(RSTD + row, rstd)


def _rms_bwd(X, W, RSTD, G, DX, DWP, N, H, stride_x, stride_g, stride_dx,
             rows_per_program, BLOCK_H: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < H
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    dw = tl.zeros([BLOCK_H], dtype=tl.float32)
    row0 = pid * rows_per_program
    for i in range(0, rows_per_program):
        row = row0 + i
        live = row < N
        m2 = mask & live
        x = tl.load(X + row * stride_x + cols, mask=m2,
                    other=0.0).to(tl.float32)
        g = tl.load(G + row * stride_g + cols, mask=m2,
                    other=0.0).to(tl.float32)
        rstd = tl.load(RSTD + row, mask=live, other=0.0)
        xhat = x * rstd
        gw = g * w
        mean = tl.sum(gw * xhat, axis=0) / H
        dx = rstd * (gw - xhat * mean)
        tl.store(DX + row * stride_dx + cols,
                 dx.to(DX.dtype.element_ty), mask=m2)
        dw += g * xhat
    tl.store(DWP + pid * H + cols, dw, mask=mask)


def _kernel(name):
    global tl
    if not _KERNELS:
        import triton
        import triton.language as tl
        _KERNELS["fwd"] = triton.jit(_rms_fwd)
        _KERNELS["bwd"] = triton.jit(_rms_bwd)
    return _KERNELS[name]


def _block_and_warps(h):
    block_h = 1 << max(0, h - 1).bit_length()
    return block_h, 8 if block_h >= 2048 else 4


def _check(name, x, weight, *rest):
    for t in (x, weight) + rest:
        if not (t.is_cuda and t.device == x.device):
            raise ValueError(f"{name} kernel: inputs must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: inputs must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name} kernel: unsupported dtype {x.dtype}")
    h = x.shape[-1]
    if weight.shape != (h,):
        raise ValueError(f"{name} kernel: weight {tuple(weight.shape)} "
                         f"does not match hidden size {h}")
    return h


def rms_norm_kernel(x, weight, eps=1e-6):
    """Launch the Triton forward on CUDA tensors -> (y, rstd [N] f32).
    Raises on anything it does not take."""
    h = _check("rms_norm", x, weight)
    x2 = x.view(-1, h)
    y = torch.empty_like(x2)
    rstd = torch.empty(x2.shape[0], dtype=torch.float32, device=x.device)
    if x2.shape[0]:
        block_h, warps = _block_and_warps(h)
        _kernel("fwd")[(x2.shape[0],)](
            x2, weight, y, rstd, h, x2.stride(0), y.stride(0), float(eps),
            BLOCK_H=block_h, num_warps=warps)
        rms_norm.launches += 1
    return y.view(x.shape), rstd


def rms_norm_bwd_kernel(x, weight, rstd, g):
    """Launch the Triton backward on CUDA tensors -> (dx, dw)."""
    h = _check("rms_norm_bwd", x, weight, rstd, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("rms_norm_bwd kernel: g must match x")
    x2, g2 = x.view(-1, h), g.view(-1, h)
    n = x2.shape[0]
    if rstd.dtype != torch.float32 or tuple(rstd.shape) != (n,):
        raise ValueError(f"rms_norm_bwd kernel: rstd must be float32 [{n}]")
    dx = torch.empty_like(x2)
    if not n:
        return dx.view(x.shape), torch.zeros_like(weight)
    rows = -(-n // min(n, _BWD_MAX_PROGRAMS))
    programs = -(-n // rows)
    partial = torch.empty((programs, h), dtype=torch.float32,
                          device=x.device)
    block_h, warps = _block_and_warps(h)
    _kernel("bwd")[(programs,)](
        x2, weight, rstd, g2, dx, partial, n, h, x2.stride(0), g2.stride(0),
        dx.stride(0), rows, BLOCK_H=block_h, num_warps=warps)
    rms_norm_bwd.launches += 1
    return dx.view(x.shape), partial.sum(0).to(weight.dtype)


def rms_norm_fwd(x, weight, eps=1e-6):
    """(y, rstd): the kernel for a CUDA tensor, the plain twin for CPU."""
    if x.device.type == "cpu":
        return rms_norm_fwd_plain(x, weight, eps)
    if x.device.type == "cuda":
        return rms_norm_kernel(x, weight, eps)
    raise ValueError(f"rms_norm: unsupported device {x.device}")


def rms_norm_bwd(x, weight, rstd, g):
    """(dx, dw): the kernel for CUDA tensors, the plain twin for CPU."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, rstd, g)
    if x.device.type == "cuda":
        return rms_norm_bwd_kernel(x, weight, rstd, g)
    raise ValueError(f"rms_norm_bwd: unsupported device {x.device}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        y, rstd = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, rstd, g.contiguous())
        return dx, dw, None


def rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last dim, differentiable in x and the weight.
    With no gradient to record (serving), the forward runs alone."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return rms_norm_fwd(x, weight, eps)[0]


rms_norm.launches = 0
rms_norm_bwd.launches = 0
