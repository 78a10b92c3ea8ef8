"""LayerNorm over the last dim, forward and backward: ``y = xhat * w + b``
with ``xhat = (x - mean) * rstd``, ``rstd = rsqrt(var + eps)`` and
``var = mean((x - mean)^2)``, statistics in f32, y in x's dtype.

Replaces the Pallas kernels ``_ln_fwd_kernel`` (launched by
``_ln_call_fwd``) and ``_ln_bwd_kernel`` (launched by ``_ln_vjp_bwd``),
``paddle_tpu/ops/pallas/norms.py:32, :79`` and ``:44, :141``.  Both are
CUDA (``csrc/norms.cu``), one launch a call, no torch op after it:

* forward: a row held in registers as 16-byte vectors, at most
  ``LNF_VALUES`` values a thread, by 8, 16 or 32 lanes of a warp or by a
  CTA (:func:`layer_norm_fwd_layout`: the SD UNet's H 320 and 640 in 16
  and 32 lanes, its H 1280 in a CTA of 160 threads; the TPU kernel's
  256-row VMEM blocks and their padding have no counterpart).  Rows of a
  warp or less run on a persistent grid, each warp issuing its next rows'
  loads before this row's sums, which are xor-shuffle butterflies (no
  shared memory, no barrier); rows of a CTA run one CTA a row.  The mean
  and then the M2 of ``x - mean`` are reduced in registers (two passes
  over registers, not over memory, never ``E[x^2] - mean^2``), and y
  (16-byte stores), mean and rstd are written once.  The weight and bias
  stay in f32 registers (loaded as x where both are in x's dtype).  Rows
  not in whole aligned vectors, or wider than the registers hold, take a
  CTA a row of scalar loads.  :func:`layer_norm_fwd_plan` is the launch's
  plan;
* backward: ``dx = rstd * (g*w - mean(g*w) - xhat * mean(g*w*xhat))``,
  ``dw = sum over rows of g * xhat`` and ``db = sum over rows of g``.
  A persistent grid of 8-warp CTAs in clusters of 8 walks the rows, one
  warp a row held in registers (16-byte vectors, the next row's loads
  issued before the current row's sums), or one CTA a row where H is
  wide or its rows are not 16-byte aligned; dw and db are summed across
  warps, CTAs and clusters in a fixed order inside the launch (no
  atomics on floats: bitwise the same run to run) and written in the
  weight's dtype.  :func:`layer_norm_bwd_plan` is the launch's plan.

Each row's sums run in a fixed order, so y, mean and rstd are bitwise the
same run to run, and a row's bits depend on the row (and its width)
alone, never on the batch.  Both are
bound by bytes: the forward moves ``2 N H`` elements plus the affine
vectors and ``8 N`` bytes of statistics, the backward ``3 N H`` (x, g in,
dx out) plus the statistics, against a few operations per element; every
read and write is a coalesced row.  The host path of each is memoized:
checks, plan and the C call's constants are made once per (device,
dtypes, shapes, alignment).

:func:`layer_norm` is differentiable (the custom op
``paddle_tpu_torch::layer_norm_fwd``, its backward registered over
``layer_norm_bwd``: ``ops/_library.py``): the kernels for CUDA tensors, the plain twins for CPU tensors, and a raise
for anything else.  :func:`layer_norm_plain` is the plain forward
differentiated by torch autograd, the reference of the kernel path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from . import _library

#: x's and the weight's dtype as ``csrc/norms.cu`` codes them
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the backward's geometry (``csrc/norms.cu``): warps a CTA, CTAs a
#: cluster, and the most 16-byte vectors of a row a lane holds
LN_WARPS, LN_CLUSTER, LN_KMAX = 8, 8, 6
#: the forward's: the most values of a row a thread holds (3 16-byte
#: vectors in 2-byte types, 6 in f32: more measured slower, its registers
#: costing occupancy), and the threads that may hold a row (8, 16 or 32
#: lanes of a warp, or a CTA of 2 to 8 warps)
LNF_VALUES = 24
LNF_THREADS = (8, 16, 32) + tuple(32 * w for w in range(2, LN_WARPS + 1))
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the C entry points' parameters (``csrc/kernels.h``) as ctypes types
ARGTYPES = {
    "layer_norm_fwd": [_P] * 5 + [_I] * 9 + [ctypes.c_float, _P],
    "layer_norm_fwd_max_ctas": [_I] * 6 + [ctypes.POINTER(_I)],
    "layer_norm_bwd": [_P] * 9 + [_I, _P] + [_I] * 6 + [_P],
    "layer_norm_bwd_max_ctas": [_I] * 3 + [ctypes.POINTER(_I)],
}
#: the launches made so far, by what decides them: (library function,
#: device index, rows or workspace floats, the C call's integer arguments)
_FWD_LAUNCHES = {}
_BWD_LAUNCHES = {}


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


def layer_norm_fwd_layout(h, item, aligned):
    """``(k, threads)`` of the forward for rows of ``h`` elements of
    ``item`` bytes: ``threads`` of ``LNF_THREADS`` hold a row in registers,
    ``k`` 16-byte vectors each (at most ``LNF_VALUES`` values), the pair
    that leaves the fewest vector slots empty, the fewest threads among
    equals; or ``(0, 0)``, the CTA-per-row kernel, for rows wider than
    that or not in whole aligned vectors.  A row's bits depend on this
    pair alone, never on the row count or the grid."""
    vw = 16 // item
    if not aligned or h % vw:
        return 0, 0
    nvec, kmax = h // vw, LNF_VALUES // vw
    fits = [(-(-nvec // t), t) for t in LNF_THREADS if -(-nvec // t) <= kmax]
    if not fits:
        return 0, 0
    return min(fits, key=lambda kt: (kt[0] * kt[1], kt[1]))


def layer_norm_fwd_plan(n, h, item, aligned, max_ctas):
    """The forward's launch for ``n`` rows of ``h`` elements of ``item``
    bytes -> ``{"k", "threads", "warps", "ctas"}``: the kernel (see
    :func:`layer_norm_fwd_layout`).  A row of at most 32 threads: CTAs of
    ``LN_WARPS`` warps, as many as give each warp the fewest groups of
    rows that ``max_ctas(k, threads, warps)`` CTAs (the most the device
    holds at once) allow.  A row of a CTA (``threads / 32`` warps; the
    row kernel's ``LN_WARPS``): one CTA a row."""
    k, threads = layer_norm_fwd_layout(h, item, aligned)
    if not 0 < threads <= 32:
        return {"k": k, "threads": threads,
                "warps": threads // 32 if k else LN_WARPS, "ctas": n}
    unit = LN_WARPS * 32 // threads              # rows a CTA takes at once
    per = -(-n // (unit * max_ctas(k, threads, LN_WARPS)))
    return {"k": k, "threads": threads, "warps": LN_WARPS,
            "ctas": -(-n // (unit * per))}


def layer_norm_fwd_rows(plan, n, cta, warp):
    """The rows that a warp (a row of at most 32 threads) or a CTA (its
    warp 0 for all of it) of the forward's ``plan`` takes, in the
    kernel's order: a warp takes groups of ``32 / threads`` rows, a CTA
    one row."""
    if not 0 < plan["threads"] <= 32:
        return [cta] if warp == 0 and cta < n else []
    rpw = 32 // plan["threads"]
    groups = range(cta * plan["warps"] + warp, -(-n // rpw),
                   plan["ctas"] * plan["warps"])
    return [g * rpw + s for g in groups for s in range(rpw)
            if g * rpw + s < n]


def _stream(index):
    """The raw handle of the current CUDA stream of device ``index`` (the
    call Triton's launcher makes: no ``torch.cuda.Stream`` is built)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _on_device(index, fn, *args):
    """``fn(*args)`` with device ``index`` current, entering its context
    only when another device is current."""
    if torch.cuda.current_device() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def _lib():
    lib = _build.load("norms")
    for name, types in ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _max_ctas(fn, name, *args):
    """An occupancy query of the library: its out-parameter."""
    out = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{name} occupancy query failed: CUDA error {rc}")
    return out.value


def _fwd_launch(x, weight, bias, plan=None):
    """Check a forward call of a new (device, dtypes, shapes, alignment)
    and make its launch (see ``_FWD_LAUNCHES``), from ``plan`` or the
    shape's own :func:`layer_norm_fwd_plan`.  Raises on anything the
    kernel does not take."""
    h = _check("layer_norm", x, weight, bias)
    if bias.shape != (h,):
        raise ValueError(f"layer_norm kernel: bias {tuple(bias.shape)} does "
                         f"not match hidden size {h}")
    for t in (weight, bias):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"layer_norm kernel: unsupported affine dtype "
                            f"{t.dtype}")
    n, dev = math.prod(x.shape[:-1]), x.device
    if not x.numel():
        return None, dev.index, n, ()
    lib = _lib()
    codes = (DTYPE_CODES[x.dtype], DTYPE_CODES[weight.dtype],
             DTYPE_CODES[bias.dtype])
    if plan is None:
        plan = _on_device(
            dev.index, layer_norm_fwd_plan, n, h, x.element_size(),
            (x.data_ptr() | weight.data_ptr() | bias.data_ptr()) % 16 == 0,
            lambda k, threads, warps: _max_ctas(
                lib.layer_norm_fwd_max_ctas, "layer_norm", *codes, k, threads,
                warps))
    return (lib.layer_norm_fwd, dev.index, n,
            (n, h, *codes, plan["k"], plan["threads"], plan["warps"],
             plan["ctas"]))


def layer_norm_kernel(x, weight, bias, eps=1e-5):
    """Launch the CUDA forward on the current stream -> (y, mean [N] f32,
    rstd [N] f32).  Raises on anything it does not take.  The checks,
    the plan and the launch's constants are made once per (device,
    dtypes, shapes, 16-byte alignment of x, weight and bias); a later
    call of the same key reads them back."""
    y, stats = _kernel_stats(x, weight, bias, eps)
    mean, rstd = stats.unbind()
    return y, mean, rstd


def _kernel_stats(x, weight, bias, eps):
    """:func:`layer_norm_kernel` with the statistics as one [2, N] f32
    tensor (mean, rstd), as the custom op returns them."""
    key = (x.device, x.dtype, x.shape, weight.device, weight.dtype,
           weight.shape, bias.device, bias.dtype, bias.shape,
           (x.data_ptr() | weight.data_ptr() | bias.data_ptr()) % 16 == 0)
    launch = _FWD_LAUNCHES.get(key)
    if launch is None:
        launch = _FWD_LAUNCHES[key] = _fwd_launch(x, weight, bias)
    return _fwd_run(launch, x, weight, bias, eps)


def _fwd_run(launch, x, weight, bias, eps):
    fn, index, n, args = launch
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("layer_norm kernel: inputs must be contiguous")
    y = torch.empty_like(x)
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    if fn is not None:
        rc = _on_device(index, fn, x.data_ptr(), weight.data_ptr(),
                        bias.data_ptr(), y.data_ptr(), stats.data_ptr(), *args,
                        eps, _stream(index))
        if rc != 0:
            raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                               f"{rc}")
        layer_norm.launches += 1
    return y, stats


def _bwd_launch(x, weight, mean, rstd, g):
    """Check a backward call of a new (device, dtypes, shapes, alignment)
    and make its launch (see ``_BWD_LAUNCHES``): the plan, with the
    occupancy queries it needs."""
    h = _check("layer_norm_bwd", x, weight, mean, rstd, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("layer_norm_bwd kernel: g must match x")
    if weight.dtype not in DTYPE_CODES:
        raise TypeError(f"layer_norm_bwd kernel: unsupported weight dtype "
                        f"{weight.dtype}")
    n, dev = math.prod(x.shape[:-1]), x.device
    for t in (mean, rstd):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"layer_norm_bwd kernel: mean and rstd must be "
                             f"float32 [{n}]")
    if not n:
        return None, dev.index, 0, ()
    lib, code = _lib(), DTYPE_CODES[x.dtype]
    plan = _on_device(
        dev.index, layer_norm_bwd_plan, n, h, x.element_size(),
        (x.data_ptr() | g.data_ptr()) % 16 == 0,
        lambda k: _max_ctas(lib.layer_norm_bwd_max_ctas, "layer_norm_bwd",
                            code, h, k))
    return (lib.layer_norm_bwd, dev.index, plan["ws"],
            (n, h, code, DTYPE_CODES[weight.dtype], plan["k"], plan["ctas"]))


def layer_norm_bwd_kernel(x, weight, mean, rstd, g):
    """Launch the CUDA backward on the current stream -> (dx, dw, db).
    Made once per key as the forward's (:func:`layer_norm_kernel`)."""
    key = (x.device, x.dtype, x.shape, weight.device, weight.dtype,
           weight.shape, mean.device, mean.dtype, mean.shape, rstd.device,
           rstd.dtype, rstd.shape, g.device, g.dtype, g.shape,
           (x.data_ptr() | g.data_ptr()) % 16 == 0)
    launch = _BWD_LAUNCHES.get(key)
    if launch is None:
        launch = _BWD_LAUNCHES[key] = _bwd_launch(x, weight, mean, rstd, g)
    fn, index, ws_floats, args = launch
    if not all(t.is_contiguous() for t in (x, weight, mean, rstd, g)):
        raise ValueError("layer_norm_bwd kernel: inputs must be contiguous")
    dx = torch.empty_like(x)
    if fn is None:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
    stream = _stream(index)
    rc = _on_device(index, fn, x.data_ptr(), weight.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), g.data_ptr(),
                    dx.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
                    ws_floats, _build.ticket(x.device, stream).data_ptr(),
                    *args, stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    layer_norm_bwd.launches += 1
    return dx, dw, db


def _fwd_impl(x, weight, bias, eps):
    if x.device.type == "cpu":
        y, mean, rstd = layer_norm_fwd_plain(x, weight, bias, eps)
        return y, torch.stack([mean, rstd])
    if x.device.type == "cuda":
        return _kernel_stats(x, weight, bias, eps)
    raise ValueError(f"layer_norm: unsupported device {x.device}")


def _fwd_fake(x, weight, bias, eps):
    n = math.prod(x.shape[:-1])
    return torch.empty_like(x), x.new_empty((2, n), dtype=torch.float32)


def _bwd_impl(x, weight, mean, rstd, g):
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, weight, mean, rstd, g)
    if x.device.type == "cuda":
        return layer_norm_bwd_kernel(x, weight, mean, rstd, g)
    raise ValueError(f"layer_norm_bwd: unsupported device {x.device}")


def _bwd_fake(x, weight, mean, rstd, g):
    return (torch.empty_like(x), torch.empty_like(weight),
            torch.empty_like(weight))


#: ``paddle_tpu_torch::layer_norm_fwd`` -> (y, stats [2, N] f32: mean
#: and rstd) and ``paddle_tpu_torch::layer_norm_bwd`` -> (dx, dw, db)
layer_norm_fwd_op = _library.define(
    "layer_norm_fwd", "(Tensor x, Tensor weight, Tensor bias, float eps) "
    "-> (Tensor, Tensor)", _fwd_impl, _fwd_fake)
layer_norm_bwd_op = _library.define(
    "layer_norm_bwd", "(Tensor x, Tensor weight, Tensor mean, Tensor rstd, "
    "Tensor g) -> (Tensor, Tensor, Tensor)", _bwd_impl, _bwd_fake)


def _setup(ctx, inputs, output):
    x, weight, _, _ = inputs
    ctx.save_for_backward(x, weight, output[1])


def _backward(ctx, g, _):
    _library.first_order("layer_norm")
    x, weight, stats = ctx.saved_tensors
    dx, dw, db = layer_norm_bwd_op(x, weight, stats[0], stats[1],
                                   g.contiguous())
    return dx, dw, db, None


layer_norm_fwd_op.register_autograd(_backward, setup_context=_setup)


def layer_norm_fwd(x, weight, bias, eps=1e-5):
    """(y, mean, rstd): the kernel for a CUDA tensor, the plain twin for
    CPU (the custom op ``layer_norm_fwd``)."""
    y, stats = layer_norm_fwd_op(x, weight, bias, float(eps))
    mean, rstd = stats.unbind()
    return y, mean, rstd


def layer_norm_bwd(x, weight, mean, rstd, g):
    """(dx, dw, db): the kernel for CUDA tensors, the plain twin for
    CPU (the custom op ``layer_norm_bwd``)."""
    return layer_norm_bwd_op(x, weight, mean, rstd, g)


def layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last dim with 1-D weight and bias,
    differentiable in all three (through the custom op's registered
    backward, the backward kernel)."""
    return layer_norm_fwd_op(x.contiguous(), weight, bias, float(eps))[0]


layer_norm.launches = 0
layer_norm_bwd.launches = 0
