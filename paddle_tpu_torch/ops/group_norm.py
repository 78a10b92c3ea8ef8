"""GroupNorm over the NC* layout, forward and backward.  x is
``[N, C, *spatial]`` with ``C % G == 0``; each (sample, group) is one row
of ``Cg * HW`` elements (``Cg = C / G``, ``HW`` the spatial size), and
``y = (x - mean) * rstd * w[c] + b[c]`` with the row's f32 ``mean`` and
``rstd = rsqrt(mean((x - mean)^2) + eps)``, y in x's dtype.

Replaces the Pallas kernels ``_gn_fwd_kernel`` (launched by
``_gn_call_fwd``) and ``_gn_bwd_kernel`` (launched by ``_gn_vjp_bwd``),
``paddle_tpu/ops/pallas/norms.py:304, :366`` and ``:318, :424``.  On the
card both are Triton kernels with one program per (sample, group) row:

* The rows are long (up to 30 x 4096 = 122,880 elements in the SD UNet)
  and few (``N * G``, 128 at batch 4), so a row never fits in registers:
  each program walks it in ``[BLOCK_C, BLOCK_HW]`` tiles, channels down
  and spatial positions across, so the per-channel weight and bias are
  a ``[BLOCK_C]`` vector read once per tile (the TPU kernel instead
  reads a broadcast ``[G, Cg * HW]`` copy of them from HBM).
* forward: three passes over the row: the sum, then the sum of
  ``(x - mean)^2`` (two passes, not ``E[x^2] - mean^2``, which cancels
  at 10^5 elements with a large mean), then y.  The row is re-read from
  L2 on the second and third pass: 128 rows of at most 240 KB (bf16)
  fit the 50 MB L2.
* backward: the first pass reduces each channel's ``sum(g)`` and
  ``sum(g * xhat)`` over its ``HW`` positions and stores them as f32
  partials ``[N, C]``; the row's ``mean(g*w)`` and ``mean(g*w*xhat)``
  follow from those and ``w`` with no second reduction.  The second pass
  writes ``dx = rstd * (g*w - mean(g*w) - xhat * mean(g*w*xhat))``.
  ``dw`` and ``db`` are the partials summed over N by one ``.sum(0)`` in
  a fixed order: deterministic, no atomics (the TPU kernel accumulates
  ``[G, Cg * HW]`` column partials in VMEM over a sequential grid and
  reduces them outside).

Bound: bytes (``2 N C HW`` elements forward, ``3 N C HW`` backward, plus
the statistics, affine vectors and partials), against a few operations
per element.  The grid of ``N * G`` programs fills at most 128 of the
H100's 132 SMs at batch 4: splitting a row over several programs is
later work, with the times in ``PERF.md``.

:func:`group_norm` is differentiable (a ``torch.autograd.Function``):
the kernels for CUDA tensors, the plain twins for CPU tensors, and a
raise for anything else.  :func:`group_norm_plain` is the plain forward
differentiated by torch autograd, the reference of the kernel path.
"""

from __future__ import annotations

import torch

#: ``triton.language``, bound at the first launch (triton is imported
#: only when a kernel is launched, so this module imports without it)
tl = None
_KERNELS = {}
_TILE = 4096           # elements of one [BLOCK_C, BLOCK_HW] tile


def _dims(x, num_groups):
    n, c = x.shape[0], x.shape[1]
    hw = 1
    for s in x.shape[2:]:
        hw *= s
    return n, c, c // num_groups, hw


def group_norm_fwd_plain(x, weight, bias, num_groups, eps=1e-5):
    """The plain twin of the forward kernel -> (y, mean [N*G] f32,
    rstd [N*G] f32)."""
    n, c, cg, hw = _dims(x, num_groups)
    xf = x.reshape(n, num_groups, cg * hw).to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    d = xf - mean
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    y = (d * rstd).reshape(n, c, hw) * weight.to(torch.float32)[:, None] \
        + bias.to(torch.float32)[:, None]
    return (y.to(x.dtype).reshape(x.shape), mean.reshape(-1),
            rstd.reshape(-1))


def group_norm_plain(x, weight, bias, num_groups, eps=1e-5):
    """The plain forward (same f32 arithmetic as the kernel)."""
    return group_norm_fwd_plain(x, weight, bias, num_groups, eps)[0]


def group_norm_bwd_plain(x, weight, mean, rstd, g, num_groups):
    """The plain twin of the backward kernel -> (dx in x's dtype, dw and
    db in the weight's dtype)."""
    n, c, cg, hw = _dims(x, num_groups)
    xf = x.reshape(n, num_groups, cg, hw).to(torch.float32)
    gf = g.reshape(n, num_groups, cg, hw).to(torch.float32)
    mean = mean.reshape(n, num_groups, 1, 1)
    rstd = rstd.reshape(n, num_groups, 1, 1)
    xhat = (xf - mean) * rstd
    gw = gf * weight.to(torch.float32).reshape(1, num_groups, cg, 1)
    m1 = gw.mean((2, 3), keepdim=True)
    m2 = (gw * xhat).mean((2, 3), keepdim=True)
    dx = rstd * (gw - m1 - xhat * m2)
    dw = (gf * xhat).sum((0, 3)).reshape(c)
    db = gf.sum((0, 3)).reshape(c)
    return (dx.to(x.dtype).reshape(x.shape), dw.to(weight.dtype),
            db.to(weight.dtype))


def _gn_fwd(X, W, B, Y, MEAN, RSTD, G, CG, HW, eps,
            BLOCK_C: tl.constexpr, BLOCK_HW: tl.constexpr):
    pid = tl.program_id(0)                  # sample * G + group
    row_len = CG * HW
    base = pid.to(tl.int64) * row_len
    w0 = (pid % G) * CG                     # first channel of the group
    cs = tl.arange(0, BLOCK_C)
    hs = tl.arange(0, BLOCK_HW)
    acc = tl.zeros([BLOCK_C, BLOCK_HW], dtype=tl.float32)
    for c0 in range(0, CG, BLOCK_C):
        for h0 in range(0, HW, BLOCK_HW):
            c = c0 + cs
            h = h0 + hs
            m = (c < CG)[:, None] & (h < HW)[None, :]
            off = base + c[:, None] * HW + h[None, :]
            acc += tl.load(X + off, mask=m, other=0.0).to(tl.float32)
    mean = tl.sum(tl.sum(acc, axis=1), axis=0) / row_len
    acc = tl.zeros([BLOCK_C, BLOCK_HW], dtype=tl.float32)
    for c0 in range(0, CG, BLOCK_C):
        for h0 in range(0, HW, BLOCK_HW):
            c = c0 + cs
            h = h0 + hs
            m = (c < CG)[:, None] & (h < HW)[None, :]
            off = base + c[:, None] * HW + h[None, :]
            x = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
            d = tl.where(m, x - mean, 0.0)
            acc += d * d
    rstd = 1.0 / tl.sqrt(tl.sum(tl.sum(acc, axis=1), axis=0) / row_len + eps)
    for c0 in range(0, CG, BLOCK_C):
        c = c0 + cs
        cm = c < CG
        w = tl.load(W + w0 + c, mask=cm, other=0.0).to(tl.float32)
        b = tl.load(B + w0 + c, mask=cm, other=0.0).to(tl.float32)
        for h0 in range(0, HW, BLOCK_HW):
            h = h0 + hs
            m = cm[:, None] & (h < HW)[None, :]
            off = base + c[:, None] * HW + h[None, :]
            x = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
            y = (x - mean) * rstd * w[:, None] + b[:, None]
            tl.store(Y + off, y.to(Y.dtype.element_ty), mask=m)
    tl.store(MEAN + pid, mean)
    tl.store(RSTD + pid, rstd)


def _gn_bwd(X, W, MEAN, RSTD, G_, DX, DWP, DBP, G, CG, HW,
            BLOCK_C: tl.constexpr, BLOCK_HW: tl.constexpr):
    pid = tl.program_id(0)                  # sample * G + group
    row_len = CG * HW
    base = pid.to(tl.int64) * row_len
    w0 = (pid % G) * CG
    mean = tl.load(MEAN + pid)
    rstd = tl.load(RSTD + pid)
    cs = tl.arange(0, BLOCK_C)
    hs = tl.arange(0, BLOCK_HW)
    s1 = tl.zeros([BLOCK_C], dtype=tl.float32)   # w * sum(g) per channel
    s2 = tl.zeros([BLOCK_C], dtype=tl.float32)   # w * sum(g * xhat)
    for c0 in range(0, CG, BLOCK_C):
        c = c0 + cs
        cm = c < CG
        acc_g = tl.zeros([BLOCK_C, BLOCK_HW], dtype=tl.float32)
        acc_gx = tl.zeros([BLOCK_C, BLOCK_HW], dtype=tl.float32)
        for h0 in range(0, HW, BLOCK_HW):
            h = h0 + hs
            m = cm[:, None] & (h < HW)[None, :]
            off = base + c[:, None] * HW + h[None, :]
            x = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
            g = tl.load(G_ + off, mask=m, other=0.0).to(tl.float32)
            acc_g += g
            acc_gx += g * tl.where(m, (x - mean) * rstd, 0.0)
        db_c = tl.sum(acc_g, axis=1)
        dw_c = tl.sum(acc_gx, axis=1)
        tl.store(DBP + pid * CG + c, db_c, mask=cm)
        tl.store(DWP + pid * CG + c, dw_c, mask=cm)
        w = tl.load(W + w0 + c, mask=cm, other=0.0).to(tl.float32)
        s1 += w * db_c
        s2 += w * dw_c
    c1 = tl.sum(s1, axis=0) / row_len
    c2 = tl.sum(s2, axis=0) / row_len
    for c0 in range(0, CG, BLOCK_C):
        c = c0 + cs
        cm = c < CG
        w = tl.load(W + w0 + c, mask=cm, other=0.0).to(tl.float32)
        for h0 in range(0, HW, BLOCK_HW):
            h = h0 + hs
            m = cm[:, None] & (h < HW)[None, :]
            off = base + c[:, None] * HW + h[None, :]
            x = tl.load(X + off, mask=m, other=0.0).to(tl.float32)
            g = tl.load(G_ + off, mask=m, other=0.0).to(tl.float32)
            xhat = (x - mean) * rstd
            dx = rstd * (g * w[:, None] - c1 - xhat * c2)
            tl.store(DX + off, dx.to(DX.dtype.element_ty), mask=m)


def _kernel(name):
    global tl
    if not _KERNELS:
        import triton
        import triton.language as tl
        _KERNELS["fwd"] = triton.jit(_gn_fwd)
        _KERNELS["bwd"] = triton.jit(_gn_bwd)
    return _KERNELS[name]


def _tiles(cg, hw):
    """(BLOCK_C, BLOCK_HW, num_warps): a tile of at most _TILE elements,
    as wide along the contiguous spatial axis as the row allows."""
    block_hw = min(1 << max(0, hw - 1).bit_length(), _TILE)
    block_c = min(1 << max(0, cg - 1).bit_length(), _TILE // block_hw)
    return block_c, block_hw, 8 if block_c * block_hw >= 2048 else 4


def _check(name, x, weight, num_groups, *rest):
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name} kernel: unsupported dtype {x.dtype}")
    if x.dim() < 3 or num_groups <= 0 or x.shape[1] % num_groups:
        raise ValueError(f"{name} kernel: shape {tuple(x.shape)} with "
                         f"{num_groups} groups (NC* with a spatial dim and "
                         "C % G == 0)")
    n, c, cg, hw = _dims(x, num_groups)
    if cg * hw >= 2 ** 31:         # offsets within a row are int32
        raise ValueError(f"{name} kernel: a row of {cg * hw} elements "
                         "(under 2**31)")
    if weight.shape != (x.shape[1],):
        raise ValueError(f"{name} kernel: weight {tuple(weight.shape)} "
                         f"does not match {c} channels")
    for t in (x, weight) + rest:
        if not (t.is_cuda and t.device == x.device):
            raise ValueError(f"{name} kernel: inputs must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: inputs must be contiguous")
    return n, c, cg, hw


def group_norm_kernel(x, weight, bias, num_groups, eps=1e-5):
    """Launch the Triton forward on CUDA tensors -> (y, mean [N*G] f32,
    rstd [N*G] f32).  Raises on anything it does not take."""
    n, c, cg, hw = _check("group_norm", x, weight, num_groups, bias)
    if bias.shape != (c,):
        raise ValueError(f"group_norm kernel: bias {tuple(bias.shape)} does "
                         f"not match {c} channels")
    y = torch.empty_like(x)
    rows = n * num_groups
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if x.numel():
        block_c, block_hw, warps = _tiles(cg, hw)
        _kernel("fwd")[(rows,)](
            x, weight, bias, y, mean, rstd, num_groups, cg, hw, float(eps),
            BLOCK_C=block_c, BLOCK_HW=block_hw, num_warps=warps)
        group_norm.launches += 1
    return y, mean, rstd


def group_norm_bwd_kernel(x, weight, mean, rstd, g, num_groups):
    """Launch the Triton backward on CUDA tensors -> (dx, dw, db)."""
    n, c, cg, hw = _check("group_norm_bwd", x, weight, num_groups, mean,
                          rstd, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("group_norm_bwd kernel: g must match x")
    rows = n * num_groups
    for t in (mean, rstd):
        if t.dtype != torch.float32 or tuple(t.shape) != (rows,):
            raise ValueError(f"group_norm_bwd kernel: mean and rstd must be "
                             f"float32 [{rows}]")
    dx = torch.empty_like(x)
    if not x.numel():
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dwp = torch.empty((n, c), dtype=torch.float32, device=x.device)
    dbp = torch.empty_like(dwp)
    block_c, block_hw, warps = _tiles(cg, hw)
    _kernel("bwd")[(rows,)](
        x, weight, mean, rstd, g, dx, dwp, dbp, num_groups, cg, hw,
        BLOCK_C=block_c, BLOCK_HW=block_hw, num_warps=warps)
    group_norm_bwd.launches += 1
    return dx, dwp.sum(0).to(weight.dtype), dbp.sum(0).to(weight.dtype)


def group_norm_fwd(x, weight, bias, num_groups, eps=1e-5):
    """(y, mean, rstd): the kernel for a CUDA tensor, the plain twin for
    CPU."""
    if x.device.type == "cpu":
        return group_norm_fwd_plain(x, weight, bias, num_groups, eps)
    if x.device.type == "cuda":
        return group_norm_kernel(x, weight, bias, num_groups, eps)
    raise ValueError(f"group_norm: unsupported device {x.device}")


def group_norm_bwd(x, weight, mean, rstd, g, num_groups):
    """(dx, dw, db): the kernel for CUDA tensors, the plain twin for
    CPU."""
    if x.device.type == "cpu":
        return group_norm_bwd_plain(x, weight, mean, rstd, g, num_groups)
    if x.device.type == "cuda":
        return group_norm_bwd_kernel(x, weight, mean, rstd, g, num_groups)
    raise ValueError(f"group_norm_bwd: unsupported device {x.device}")


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        y, mean, rstd = group_norm_fwd(x, weight, bias, num_groups, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = group_norm_bwd(x, weight, mean, rstd, g.contiguous(),
                                    ctx.num_groups)
        return dx, dw, db, None, None


def group_norm(x, weight, bias, num_groups, eps=1e-5):
    """GroupNorm over NC* with 1-D weight and bias of C entries,
    differentiable in all three.  With no gradient to record, the
    forward runs alone."""
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        return _GroupNorm.apply(x, weight, bias, num_groups, eps)
    return group_norm_fwd(x, weight, bias, num_groups, eps)[0]


group_norm.launches = 0
group_norm_bwd.launches = 0
