"""LayerNorm over the last dim, forward and backward: ``y = xhat * w + b``
with ``xhat = (x - mean) * rstd``, ``rstd = rsqrt(var + eps)`` and
``var = mean((x - mean)^2)``, statistics in f32, y in x's dtype.

Replaces the Pallas kernels ``_ln_fwd_kernel`` (launched by
``_ln_call_fwd``) and ``_ln_bwd_kernel`` (launched by ``_ln_vjp_bwd``),
``paddle_tpu/ops/pallas/norms.py:32, :79`` and ``:44, :141``:

* forward, a Triton kernel: one program per row with ``BLOCK_H`` the
  next power of two >= H (512, 1024, 2048 for the UNet's 320, 640,
  1280); the row is read once, the mean and then the variance of
  ``x - mean`` are reduced in registers (two passes over registers, not
  over memory), and y, mean and rstd are written once;
* backward, CUDA (``csrc/norms.cu``, one launch a call):
  ``dx = rstd * (g*w - mean(g*w) - xhat * mean(g*w*xhat))``,
  ``dw = sum over rows of g * xhat`` and ``db = sum over rows of g``.
  A persistent grid of 8-warp CTAs in clusters of 8 walks the rows, one
  warp a row held in registers (16-byte vectors, the next row's loads
  issued before the current row's sums), or one CTA a row where H is
  wide or its rows are not 16-byte aligned; dw and db are summed across
  warps, CTAs and clusters in a fixed order inside the launch (no
  atomics on floats: bitwise the same run to run) and written in the
  weight's dtype.  :func:`layer_norm_bwd_plan` is the launch's plan.

Both are bound by bytes: the forward moves ``2 N H`` elements plus the
affine vectors and ``8 N`` bytes of statistics, the backward ``3 N H``
(x, g in, dx out) plus the statistics, against a few operations per
element; every read and write is a coalesced row.

:func:`layer_norm` is differentiable (a ``torch.autograd.Function``): the
kernels for CUDA tensors, the plain twins for CPU tensors, and a raise
for anything else.  :func:`layer_norm_plain` is the plain forward
differentiated by torch autograd, the reference of the kernel path.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: ``triton.language``, bound at the first launch (triton is imported
#: only when a kernel is launched, so this module imports without it)
tl = None
_KERNELS = {}
#: x's and the weight's dtype as ``csrc/norms.cu`` codes them
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the backward's geometry (``csrc/norms.cu``): warps a CTA, CTAs a
#: cluster, and the most 16-byte vectors of a row a lane holds
LN_WARPS, LN_CLUSTER, LN_KMAX = 8, 8, 6
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the C entry points' parameters (``csrc/kernels.h``) as ctypes types
ARGTYPES = {
    "layer_norm_bwd": [_P] * 9 + [_I, _P] + [_I] * 6 + [_P],
    "layer_norm_bwd_max_ctas": [_I] * 3 + [ctypes.POINTER(_I)],
}
_MAX_CTAS = {}


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


def _fwd_kernel():
    global tl
    if not _KERNELS:
        import triton
        import triton.language as tl
        _KERNELS["fwd"] = triton.jit(_ln_fwd)
    return _KERNELS["fwd"]


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
        _fwd_kernel()[(n,)](
            x2, weight, bias, y, mean, rstd, h, x2.stride(0), y.stride(0),
            float(eps), BLOCK_H=block_h, num_warps=warps)
        layer_norm.launches += 1
    return y.view(x.shape), mean, rstd


def layer_norm_bwd_chunks(h, item, aligned):
    """The 16-byte vectors of a row that one lane of the warp-per-row
    kernel holds, or 0 for the CTA-per-row kernel (rows wider than
    ``LN_KMAX`` vectors a lane, or not in whole aligned vectors)."""
    vw = 16 // item
    k = -(-h // (32 * vw))
    return k if aligned and h % vw == 0 and k <= LN_KMAX else 0


def layer_norm_bwd_plan(n, h, item, aligned, max_ctas):
    """The backward's launch for ``n`` rows of ``h`` elements of
    ``item`` bytes -> ``{"k", "ctas", "ws"}``: the kernel (see
    :func:`layer_norm_bwd_chunks`), the CTAs and the f32 workspace
    (cluster partials, and the row kernel's per-CTA sums).  The CTAs are
    whole clusters, at most ``max_ctas(k)`` (the most the device holds at
    once), and no more than give each warp (row kernel: each CTA) the
    fewest rows that many CTAs allow: a warp with one row more than the
    others would set the time, and fewer CTAs leave fewer partials."""
    k = layer_norm_bwd_chunks(h, item, aligned)
    per, cap = (LN_WARPS if k else 1), max_ctas(k)
    rows = -(-n // (per * cap))             # rows of the busiest warp
    ctas = -(-n // (per * rows) // LN_CLUSTER) * LN_CLUSTER
    return {"k": k, "ctas": ctas,
            "ws": (ctas // LN_CLUSTER + (0 if k else ctas)) * 2 * h}


def layer_norm_bwd_rows(plan, n, cta, warp):
    """The rows that a warp (``k`` > 0) or a CTA (``k`` = 0, its warp 0
    for all of it) of ``plan`` takes, in the kernel's order."""
    if plan["k"]:
        return range(cta * LN_WARPS + warp, n, plan["ctas"] * LN_WARPS)
    return range(cta, n, plan["ctas"]) if warp == 0 else range(0)


def _lib():
    lib = _build.load("norms")
    for name, types in ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _max_ctas(lib, device, code, h, k):
    key = (device.index, code, h, k)
    if key not in _MAX_CTAS:
        out = ctypes.c_int(0)
        rc = lib.layer_norm_bwd_max_ctas(code, h, k, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"layer_norm_bwd occupancy query failed: CUDA "
                               f"error {rc}")
        _MAX_CTAS[key] = out.value
    return _MAX_CTAS[key]


def layer_norm_bwd_kernel(x, weight, mean, rstd, g):
    """Launch the CUDA backward on the current stream -> (dx, dw, db)."""
    h = _check("layer_norm_bwd", x, weight, mean, rstd, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("layer_norm_bwd kernel: g must match x")
    if weight.dtype not in DTYPE_CODES:
        raise TypeError(f"layer_norm_bwd kernel: unsupported weight dtype "
                        f"{weight.dtype}")
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
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    dev, code = x.device, DTYPE_CODES[x.dtype]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, g2, dx))
    with torch.cuda.device(dev):
        lib = _lib()
        plan = layer_norm_bwd_plan(
            n, h, x.element_size(), aligned,
            lambda k: _max_ctas(lib, dev, code, h, k))
        ws = torch.empty(plan["ws"], dtype=torch.float32, device=dev)
        rc = lib.layer_norm_bwd(
            x2.data_ptr(), weight.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), g2.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            db.data_ptr(), ws.data_ptr(), ws.numel(),
            _build.ticket(dev).data_ptr(), n, h, code,
            DTYPE_CODES[weight.dtype], plan["k"], plan["ctas"],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    layer_norm_bwd.launches += 1
    return dx.view(x.shape), dw, db


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
