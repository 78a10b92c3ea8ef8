"""LayerNorm over the last dim, forward and backward: ``y = xhat * w + b``
with ``xhat = (x - mean) * rstd``, ``rstd = rsqrt(var + eps)`` and
``var = mean((x - mean)^2)``, statistics in f32, y in x's dtype.

Replaces the Pallas kernels ``_ln_fwd_kernel`` (launched by
``_ln_call_fwd``) and ``_ln_bwd_kernel`` (launched by ``_ln_vjp_bwd``),
``paddle_tpu/ops/pallas/norms.py:32, :79`` and ``:44, :141``.  On the
card both are Triton kernels:

* forward: one program per row with ``BLOCK_H`` the next power of two
  >= H (512, 1024, 2048 for the UNet's 320, 640, 1280); the row is read
  once, the mean and then the variance of ``x - mean`` are reduced in
  registers (two passes over registers, not over memory), and y, mean
  and rstd are written once;
* backward: ``dx = rstd * (g*w - mean(g*w) - xhat * mean(g*w*xhat))``,
  ``dw = sum over rows of g * xhat`` and ``db = sum over rows of g``.
  The TPU kernel carries dw and db in scratch from one row block to the
  next; blocks on the card run in no order, so each program walks its
  own run of rows and writes f32 partials ``[n_programs, H]``, and one
  ``.sum(0)`` over each adds them in a fixed order (deterministic, no
  atomics), as ``rms_norm.py`` does.

Both are bound by bytes: the forward moves ``2 N H`` elements plus the
affine vectors and ``8 N`` bytes of statistics, the backward ``3 N H``
(x, g in, dx out) plus the statistics and partials, against a few
operations per element; every read and write is a coalesced row.

:func:`layer_norm` is differentiable (a ``torch.autograd.Function``): the
kernels for CUDA tensors, the plain twins for CPU tensors, and a raise
for anything else.  :func:`layer_norm_plain` is the plain forward
differentiated by torch autograd, the reference of the kernel path.
"""

from __future__ import annotations

import torch

#: ``triton.language``, bound at the first launch (triton is imported
#: only when a kernel is launched, so this module imports without it)
tl = None
_KERNELS = {}
_BWD_MAX_PROGRAMS = 512


def layer_norm_fwd_plain(x, weight, bias, eps=1e-5):
    """The plain twin of the forward kernel -> (y, mean [N] f32,
    rstd [N] f32)."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    d = xf - mean
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    y = d * rstd * weight.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_plain(x, weight, bias, eps=1e-5):
    """The plain forward (same f32 arithmetic as the kernel)."""
    return layer_norm_fwd_plain(x, weight, bias, eps)[0]


def layer_norm_bwd_plain(x, weight, mean, rstd, g):
    """The plain twin of the backward kernel -> (dx in x's dtype, dw and
    db in the weight's dtype)."""
    h = x.shape[-1]
    xf = x.reshape(-1, h).to(torch.float32)
    gf = g.reshape(-1, h).to(torch.float32)
    rstd = rstd.reshape(-1, 1)
    xhat = (xf - mean.reshape(-1, 1)) * rstd
    gw = gf * weight.to(torch.float32)
    m1 = gw.mean(-1, keepdim=True)
    m2 = (gw * xhat).mean(-1, keepdim=True)
    dx = rstd * (gw - m1 - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape),
            (gf * xhat).sum(0).to(weight.dtype), gf.sum(0).to(weight.dtype))


def _ln_fwd(X, W, B, Y, MEAN, RSTD, H, stride_x, stride_y, eps,
            BLOCK_H: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < H
    x = tl.load(X + row * stride_x + cols, mask=mask,
                other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / H
    d = tl.where(mask, x - mean, 0.0)
    rstd = 1.0 / tl.sqrt(tl.sum(d * d, axis=0) / H + eps)
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(B + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(Y + row * stride_y + cols,
             (d * rstd * w + b).to(Y.dtype.element_ty), mask=mask)
    tl.store(MEAN + row, mean)
    tl.store(RSTD + row, rstd)


def _ln_bwd(X, W, MEAN, RSTD, G, DX, DWP, DBP, N, H, stride_x, stride_g,
            stride_dx, rows_per_program, BLOCK_H: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < H
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    dw = tl.zeros([BLOCK_H], dtype=tl.float32)
    db = tl.zeros([BLOCK_H], dtype=tl.float32)
    row0 = pid * rows_per_program
    for i in range(0, rows_per_program):
        row = row0 + i
        live = row < N
        m2 = mask & live
        x = tl.load(X + row * stride_x + cols, mask=m2,
                    other=0.0).to(tl.float32)
        g = tl.load(G + row * stride_g + cols, mask=m2,
                    other=0.0).to(tl.float32)
        mean = tl.load(MEAN + row, mask=live, other=0.0)
        rstd = tl.load(RSTD + row, mask=live, other=0.0)
        xhat = tl.where(m2, (x - mean) * rstd, 0.0)
        gw = g * w
        c1 = tl.sum(gw, axis=0) / H
        c2 = tl.sum(gw * xhat, axis=0) / H
        dx = rstd * (gw - c1 - xhat * c2)
        tl.store(DX + row * stride_dx + cols,
                 dx.to(DX.dtype.element_ty), mask=m2)
        dw += g * xhat
        db += g
    tl.store(DWP + pid * H + cols, dw, mask=mask)
    tl.store(DBP + pid * H + cols, db, mask=mask)


def _kernel(name):
    global tl
    if not _KERNELS:
        import triton
        import triton.language as tl
        _KERNELS["fwd"] = triton.jit(_ln_fwd)
        _KERNELS["bwd"] = triton.jit(_ln_bwd)
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
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name} kernel: {x.numel()} elements exceed int32 "
                         "offsets")
    h = x.shape[-1]
    if weight.shape != (h,):
        raise ValueError(f"{name} kernel: weight {tuple(weight.shape)} "
                         f"does not match hidden size {h}")
    return h


def layer_norm_kernel(x, weight, bias, eps=1e-5):
    """Launch the Triton forward on CUDA tensors -> (y, mean [N] f32,
    rstd [N] f32).  Raises on anything it does not take."""
    h = _check("layer_norm", x, weight, bias)
    if bias.shape != (h,):
        raise ValueError(f"layer_norm kernel: bias {tuple(bias.shape)} does "
                         f"not match hidden size {h}")
    x2 = x.view(-1, h)
    n = x2.shape[0]
    y = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        block_h, warps = _block_and_warps(h)
        _kernel("fwd")[(n,)](
            x2, weight, bias, y, mean, rstd, h, x2.stride(0), y.stride(0),
            float(eps), BLOCK_H=block_h, num_warps=warps)
        layer_norm.launches += 1
    return y.view(x.shape), mean, rstd


def layer_norm_bwd_kernel(x, weight, mean, rstd, g):
    """Launch the Triton backward on CUDA tensors -> (dx, dw, db)."""
    h = _check("layer_norm_bwd", x, weight, mean, rstd, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("layer_norm_bwd kernel: g must match x")
    x2, g2 = x.view(-1, h), g.view(-1, h)
    n = x2.shape[0]
    for t in (mean, rstd):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"layer_norm_bwd kernel: mean and rstd must be "
                             f"float32 [{n}]")
    dx = torch.empty_like(x2)
    if not n:
        return dx.view(x.shape), torch.zeros_like(weight), \
            torch.zeros_like(weight)
    rows = -(-n // min(n, _BWD_MAX_PROGRAMS))
    programs = -(-n // rows)
    dwp = torch.empty((programs, h), dtype=torch.float32, device=x.device)
    dbp = torch.empty_like(dwp)
    block_h, warps = _block_and_warps(h)
    _kernel("bwd")[(programs,)](
        x2, weight, mean, rstd, g2, dx, dwp, dbp, n, h, x2.stride(0),
        g2.stride(0), dx.stride(0), rows, BLOCK_H=block_h, num_warps=warps)
    layer_norm_bwd.launches += 1
    return (dx.view(x.shape), dwp.sum(0).to(weight.dtype),
            dbp.sum(0).to(weight.dtype))


def layer_norm_fwd(x, weight, bias, eps=1e-5):
    """(y, mean, rstd): the kernel for a CUDA tensor, the plain twin for
    CPU."""
    if x.device.type == "cpu":
        return layer_norm_fwd_plain(x, weight, bias, eps)
    if x.device.type == "cuda":
        return layer_norm_kernel(x, weight, bias, eps)
    raise ValueError(f"layer_norm: unsupported device {x.device}")


def layer_norm_bwd(x, weight, mean, rstd, g):
    """(dx, dw, db): the kernel for CUDA tensors, the plain twin for
    CPU."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, weight, mean, rstd, g)
    if x.device.type == "cuda":
        return layer_norm_bwd_kernel(x, weight, mean, rstd, g)
    raise ValueError(f"layer_norm_bwd: unsupported device {x.device}")


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, mean, rstd, g.contiguous())
        return dx, dw, db, None


def layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last dim with 1-D weight and bias,
    differentiable in all three.  With no gradient to record, the
    forward runs alone."""
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        return _LayerNorm.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps)[0]


layer_norm.launches = 0
layer_norm_bwd.launches = 0
