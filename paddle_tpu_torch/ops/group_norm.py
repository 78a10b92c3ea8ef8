"""GroupNorm over the NC* layout, forward and backward.  x is
``[N, C, *spatial]`` with ``C % G == 0``; each (sample, group) is one row
of ``Cg * HW`` elements (``Cg = C / G``, ``HW`` the spatial size), and
``y = (x - mean) * rstd * w[c] + b[c]`` with the row's f32 ``mean`` and
``rstd = rsqrt(mean((x - mean)^2) + eps)``, y in x's dtype.

Replaces the Pallas kernels ``_gn_fwd_kernel`` (launched by
``_gn_call_fwd``) and ``_gn_bwd_kernel`` (launched by ``_gn_vjp_bwd``),
``paddle_tpu/ops/pallas/norms.py:304, :366`` and ``:318, :424``.

* forward, CUDA (``csrc/norms.cu``, one launch a call).  The rows are
  long (up to 30 x 4096 = 122,880 elements in the SD UNet) and few
  (``N * G``, 128 at batch 4): one CTA a row would stream 128 rows with
  a few KB in flight each, so a row is split over a cluster of ``S``
  CTAs, each taking a run of whole channels (:func:`group_norm_fwd_plan`
  sizes ``S`` from the shape).  A CTA loads its chunk once, into
  registers for a row of at most ``FWD_STREAM_MAX`` bytes, else into
  shared memory with TMA bulk copies (or streams a chunk too large for
  it), takes its sum and then the sum of ``(x - mean_chunk)^2`` (two
  passes, not ``E[x^2] - mean^2``, which cancels at 10^5 elements with
  a large mean), and the ranks merge those partials in rank order through
  distributed shared memory (Chan's formula): every rank holds the
  row's mean and rstd bit for bit, and writes its y from the chunk.
  The per-channel weight and bias are read once a CTA (the TPU kernel
  instead reads a broadcast ``[G, Cg * HW]`` copy of them from HBM).
  The host path is memoized: checks, plan and the C call's constants
  are made once per (device, dtypes, shapes, alignment).
* backward, CUDA (``csrc/norms.cu``, one launch a call): clusters of
  ``S`` CTAs, as many as the card holds, each walking rows; each CTA
  takes a run of whole channels of a row, which it loads once into
  shared memory with TMA bulk copies (the next row's chunk loads while
  this one is reduced); each channel's
  ``sum(g)`` and ``sum(g * xhat)`` are the ``[N, C]`` dw/db partials,
  the row's ``mean(g*w)`` and ``mean(g*w*xhat)`` are summed across the
  cluster through distributed shared memory, and ``dx = rstd * (g*w -
  mean(g*w) - xhat * mean(g*w*xhat))`` is written from shared memory:
  x and g are read once.  A chunk too large for shared memory streams
  from device memory twice (16-byte vectors, or scalars where ``HW`` is
  not a whole number of them).  The last CTA sums the partials over N
  in a fixed order (no atomics on floats) into dw and db in the
  weight's dtype, the last cluster's CTAs splitting the channels.  :func:`group_norm_bwd_plan` is the launch's plan.

Bound: bytes (``2 N C HW`` elements forward, ``3 N C HW`` backward, plus
the statistics and affine vectors), against a few operations per element.

:func:`group_norm` is differentiable (a ``torch.autograd.Function``):
the kernels for CUDA tensors, the plain twins for CPU tensors, and a
raise for anything else.  :func:`group_norm_plain` is the plain forward
differentiated by torch autograd, the reference of the kernel path.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .layer_norm import DTYPE_CODES, _on_device, _stream

#: the backward's geometry (``csrc/norms.cu``): warps a CTA, CTAs a
#: cluster at most (the portable cluster size), rows of chunks a CTA holds
#: in mode 0 (one summed, one awaiting its dx, one loading)
GN_WARPS, GN_MAX_CLUSTER, GN_STAGES = 8, 8, 3
#: the forward's: warps a CTA, and the bytes of x a bulk copy brings at
#: most (one barrier each)
GNF_WARPS, GNF_PIECE = 8, 32768
#: dynamic shared memory a CTA may ask for: the H100's 227 KB per block
#: less room for the kernel's static shared memory
SMEM_MAX = 232448 - 128
#: the largest x + g chunk the plan gives a CTA where the row splits
#: finer (a CTA holds GN_STAGES of them)
CHUNK_TARGET = 64 * 1024
#: the forward's plan, from a sweep on the card over the SD-UNet step's
#: GroupNorm shapes (PERF.md §6): a row of at most FWD_ROW_MAX bytes
#: is one CTA's; a longer one splits into chunks of at most
#: FWD_CHUNK_TARGET bytes (several CTAs an SM then overlap their loads and
#: stores); a row of at most FWD_STREAM_MAX bytes is loaded straight
#: into registers (as many 16-byte vectors a thread of 256 as FWD_HOLDS
#: allows: cheaper there than bulk copies and shared-memory passes), a
#: longer one is staged
FWD_ROW_MAX, FWD_CHUNK_TARGET = 128 * 1024, 32 * 1024
#: the vectors a streaming forward thread loads at once, and holds where
#: the chunk fits: the kernel's instantiations (an unused slot costs, so
#: the plan takes the smallest that holds the chunk)
FWD_HOLDS = (4, 8, 10)
FWD_STREAM_MAX = FWD_HOLDS[-1] * 16 * GNF_WARPS * 32
#: x and g of all rows together, in bytes, above which the chunks are
#: staged in shared memory (mode 0).  Below it the rows in flight fit the
#: H100's 50 MB L2, so the streamed kernel's second pass over a row comes
#: from L2 and device memory still moves each byte once; measured on the
#: card at every GroupNorm shape of the SD-UNet step, the streamed kernel
#: with one CTA a row is then the faster (PERF.md §6).
STAGED_MIN_BYTES = 32 * 1024 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the C entry points' parameters (``csrc/kernels.h``) as ctypes types
ARGTYPES = {
    "group_norm_fwd": [_P] * 5 + [_I] * 11 + [ctypes.c_float, _P],
    "group_norm_bwd": [_P] * 10 + [_I] * 10 + [_P],
    "group_norm_bwd_max_clusters": [_I] * 4 + [ctypes.POINTER(_I)],
}
#: the launches made so far, by what decides them: (library function,
#: device index, rows, the C call's integer arguments)
_FWD_LAUNCHES = {}
_BWD_LAUNCHES = {}


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


def group_norm_fwd_smem(mode, max_ch, hw, item):
    """Dynamic shared memory of a forward CTA (``gn_fwd_smem_bytes`` in
    ``csrc/norms.cu``): in mode 0 the chunk of ``max_ch`` channels and a
    barrier a ``GNF_PIECE``; the exchange's barrier and every rank's (sum,
    M2); the chunk's weights and biases in f32."""
    chunk = max_ch * hw * item if mode == 0 else 0
    return chunk + 8 * (-(-chunk // GNF_PIECE) + 1 + GN_MAX_CLUSTER + max_ch)


def group_norm_fwd_hold(mode, max_ch, hw, item):
    """The vectors a forward thread loads at once (``hold`` of
    :func:`group_norm_fwd_plan`): 1 staged (mode 0), 4 scalars (mode 2);
    streamed vectors (mode 1), the smallest of ``FWD_HOLDS`` in which a
    CTA's threads hold the chunk, the largest where none does."""
    if mode != 1:
        return 1 if mode == 0 else 4
    per_thread = -(-(max_ch * hw * item // 16) // (GNF_WARPS * 32))
    return next((k for k in FWD_HOLDS if k >= per_thread), FWD_HOLDS[-1])


def group_norm_fwd_plan(n, c, groups, hw, item, aligned):
    """The forward's launch -> ``{"mode", "hold", "cluster", "max_ch",
    "smem", "ctas"}``: a cluster of ``S`` CTAs a (sample, group) row,
    ``N * G * S`` CTAs in all, rank r taking channels
    ``group_norm_fwd_chunks``.  ``S``
    is 1 for a row of at most ``FWD_ROW_MAX`` bytes, else the smallest (at
    most 8 and ``Cg``) that gives no CTA more than ``FWD_CHUNK_TARGET``
    bytes of x, the largest where none does.  Mode 0 (the chunk staged in
    shared memory by bulk copies) for a row over ``FWD_STREAM_MAX`` bytes
    where ``hw * item`` is a whole number of 16-byte vectors (with
    ``aligned`` tensors) and the chunk fits ``SMEM_MAX``; otherwise mode 1
    (streamed vectors) or, without 16-byte vectors, mode 2 (streamed
    scalars); ``hold`` from :func:`group_norm_fwd_hold`."""
    cg = c // groups
    per = lambda s: -(-cg // s)                  # channels of the widest CTA
    row = cg * hw * item
    s = 1
    if row > FWD_ROW_MAX:
        top = min(GN_MAX_CLUSTER, cg)
        s = next((s for s in range(2, top + 1)
                  if per(s) * hw * item <= FWD_CHUNK_TARGET), top)
    vec = aligned and (hw * item) % 16 == 0
    staged = row > FWD_STREAM_MAX \
        and group_norm_fwd_smem(0, per(s), hw, item) <= SMEM_MAX
    mode = 0 if vec and staged else 1 if vec else 2
    return {"mode": mode, "hold": group_norm_fwd_hold(mode, per(s), hw, item),
            "cluster": s, "max_ch": per(s),
            "smem": group_norm_fwd_smem(mode, per(s), hw, item),
            "ctas": n * groups * s}


def group_norm_fwd_chunks(plan, cg):
    """The channels ``[c0, c1)`` of a row that each CTA of its cluster
    takes, in rank order (as the kernel splits them and merges their
    statistics)."""
    s = plan["cluster"]
    return [(r * cg // s, (r + 1) * cg // s) for r in range(s)]


def _fwd_launch(x, weight, bias, num_groups, plan=None):
    """Check a forward call of a new (device, dtypes, shapes, alignment)
    and make its launch (see ``_FWD_LAUNCHES``), from ``plan`` or the
    shape's own :func:`group_norm_fwd_plan`.  Raises on anything the
    kernel does not take."""
    n, c, cg, hw = _check("group_norm", x, weight, num_groups, bias)
    if bias.shape != (c,):
        raise ValueError(f"group_norm kernel: bias {tuple(bias.shape)} does "
                         f"not match {c} channels")
    for t in (weight, bias):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"group_norm kernel: unsupported affine dtype "
                            f"{t.dtype}")
    rows = n * num_groups
    if not x.numel():
        return None, x.device.index, rows, ()
    if plan is None:
        plan = group_norm_fwd_plan(n, c, num_groups, hw, x.element_size(),
                                   x.data_ptr() % 16 == 0)
    return (_lib().group_norm_fwd, x.device.index, rows,
            (n, c, num_groups, hw, DTYPE_CODES[x.dtype],
             DTYPE_CODES[weight.dtype], DTYPE_CODES[bias.dtype], plan["mode"],
             plan["hold"], plan["cluster"], plan["smem"]))


def group_norm_kernel(x, weight, bias, num_groups, eps=1e-5):
    """Launch the CUDA forward on the current stream -> (y, mean [N*G] f32,
    rstd [N*G] f32).  Raises on anything it does not take.  The checks,
    the plan and the launch's constants are made once per (device,
    dtypes, shapes, 16-byte alignment of x); a later call of the same
    key reads them back."""
    key = (x.device, x.dtype, x.shape, num_groups, weight.device,
           weight.dtype, weight.shape, bias.device, bias.dtype, bias.shape,
           x.data_ptr() % 16 == 0)
    launch = _FWD_LAUNCHES.get(key)
    if launch is None:
        launch = _FWD_LAUNCHES[key] = _fwd_launch(x, weight, bias, num_groups)
    return _fwd_run(launch, x, weight, bias, eps)


def _fwd_run(launch, x, weight, bias, eps):
    fn, index, rows, args = launch
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("group_norm kernel: inputs must be contiguous")
    y = torch.empty_like(x)
    stats = torch.empty((2, rows), dtype=torch.float32, device=x.device)
    if fn is not None:
        rc = _on_device(index, fn, x.data_ptr(), weight.data_ptr(),
                        bias.data_ptr(), y.data_ptr(), stats.data_ptr(), *args,
                        eps, _stream(index))
        if rc != 0:
            raise RuntimeError(f"group_norm kernel launch failed: CUDA error "
                               f"{rc}")
        group_norm.launches += 1
    return y, stats[0], stats[1]


def group_norm_bwd_smem(mode, max_ch, hw, item):
    """Dynamic shared memory of a backward CTA (``gn_smem_bytes`` in
    ``csrc/norms.cu``): in mode 0 ``GN_STAGES`` stages of x and g chunks
    of ``max_ch`` channels and a barrier per channel and stage; the
    per-warp and per-channel sums of a row and the weights of two rows."""
    chunk = max_ch * hw * item if mode == 0 else 0
    return (2 * GN_STAGES * chunk + (8 * GN_STAGES * max_ch if mode == 0 else 0)
            + 8 * max(GN_WARPS, max_ch) + 16 * max_ch)


def group_norm_bwd_plan(n, c, groups, hw, item, aligned, sms, max_clusters):
    """The backward's launch -> ``{"mode", "cluster", "max_ch", "smem",
    "clusters"}``.  ``hw * item`` a whole number of 16-byte vectors (with
    ``aligned`` tensors) gives mode 0, the chunks staged in shared memory,
    where x and g together exceed ``STAGED_MIN_BYTES`` and ``GN_STAGES``
    chunks fit at the largest cluster; otherwise mode 1 (streamed
    vectors); scalars stream in mode 2.  The cluster size ``S`` (at most
    8 and ``Cg``): in mode 0 the smallest that gives ``2 * sms`` CTAs over
    the ``N * G`` rows with chunks of at most ``CHUNK_TARGET`` bytes, the
    largest where none does; streamed, the smallest that gives ``sms / 2``
    CTAs (one CTA a row at the SD-UNet's 128 rows, where splitting a row
    measured slower).  The grid holds as many clusters as the device runs
    at once (``max_clusters(mode, S, smem)``), at most one a row; each
    walks rows ``cluster, cluster + clusters, ...``
    (:func:`group_norm_bwd_rows`)."""
    cg, rows = c // groups, n * groups
    top = min(GN_MAX_CLUSTER, cg)
    per = lambda s: -(-cg // s)                  # channels of the widest CTA
    vec = aligned and (hw * item) % 16 == 0
    if vec and 2 * n * c * hw * item > STAGED_MIN_BYTES \
            and group_norm_bwd_smem(0, per(top), hw, item) <= SMEM_MAX:
        mode = 0
        s = next((s for s in range(1, top + 1) if rows * s >= 2 * sms
                  and 2 * per(s) * hw * item <= CHUNK_TARGET), top)
    else:
        mode = 1 if vec else 2
        s = next((s for s in range(1, top + 1) if 2 * rows * s >= sms), top)
    smem = group_norm_bwd_smem(mode, per(s), hw, item)
    return {"mode": mode, "cluster": s, "max_ch": per(s), "smem": smem,
            "clusters": min(rows, max_clusters(mode, s, smem))}


def group_norm_bwd_rows(plan, rows, cluster):
    """The (sample, group) rows one cluster of ``plan`` walks, in order."""
    return range(cluster, rows, plan["clusters"])


def group_norm_bwd_chunks(plan, cg):
    """The channels ``[c0, c1)`` of a row that each CTA of a cluster
    takes, in rank order (as the kernel splits them)."""
    s = plan["cluster"]
    return [(r * cg // s, (r + 1) * cg // s) for r in range(s)]


def _lib():
    lib = _build.load("norms")
    for name, types in ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _max_clusters(lib, code, mode, s, smem):
    out = ctypes.c_int(0)
    rc = lib.group_norm_bwd_max_clusters(code, mode, s, smem,
                                         ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"group_norm_bwd occupancy query failed: CUDA "
                           f"error {rc}")
    return out.value


def _bwd_launch(x, weight, mean, rstd, g, num_groups):
    """Check a backward call of a new (device, dtypes, shapes, alignment)
    and make its launch (see ``_BWD_LAUNCHES``): the plan, with the
    device's multiprocessors and the occupancy queries it needs."""
    n, c, cg, hw = _check("group_norm_bwd", x, weight, num_groups, mean,
                          rstd, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("group_norm_bwd kernel: g must match x")
    if weight.dtype not in DTYPE_CODES:
        raise TypeError(f"group_norm_bwd kernel: unsupported weight dtype "
                        f"{weight.dtype}")
    rows = n * num_groups
    for t in (mean, rstd):
        if t.dtype != torch.float32 or tuple(t.shape) != (rows,):
            raise ValueError(f"group_norm_bwd kernel: mean and rstd must be "
                             f"float32 [{rows}]")
    dev, code = x.device, DTYPE_CODES[x.dtype]
    if not x.numel():
        return None, dev.index, rows, ()
    lib = _lib()
    plan = _on_device(dev.index, group_norm_bwd_plan, n, c, num_groups, hw,
                      x.element_size(),
                      (x.data_ptr() | g.data_ptr()) % 16 == 0,
                      torch.cuda.get_device_properties(dev)
                      .multi_processor_count,
                      lambda mode, s, smem: _max_clusters(lib, code, mode, s,
                                                          smem))
    return (lib.group_norm_bwd, dev.index, rows,
            (n, c, num_groups, hw, code, DTYPE_CODES[weight.dtype],
             plan["mode"], plan["cluster"], plan["clusters"], plan["smem"]))


def group_norm_bwd_kernel(x, weight, mean, rstd, g, num_groups):
    """Launch the CUDA backward on the current stream -> (dx, dw, db).
    Made once per key as the forward's (:func:`group_norm_kernel`)."""
    key = (x.device, x.dtype, x.shape, num_groups, weight.device,
           weight.dtype, weight.shape, mean.device, mean.dtype, mean.shape,
           rstd.device, rstd.dtype, rstd.shape, g.device, g.dtype, g.shape,
           (x.data_ptr() | g.data_ptr()) % 16 == 0)
    launch = _BWD_LAUNCHES.get(key)
    if launch is None:
        launch = _BWD_LAUNCHES[key] = _bwd_launch(x, weight, mean, rstd, g,
                                                  num_groups)
    fn, index, rows, args = launch
    if not all(t.is_contiguous() for t in (x, weight, mean, rstd, g)):
        raise ValueError("group_norm_bwd kernel: inputs must be contiguous")
    dx = torch.empty_like(x)
    if fn is None:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    ws = torch.empty((args[0], 2, args[1]), dtype=torch.float32,
                     device=x.device)
    stream = _stream(index)
    rc = _on_device(index, fn, x.data_ptr(), weight.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), g.data_ptr(),
                    dx.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(),
                    _build.ticket(x.device, stream).data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    group_norm_bwd.launches += 1
    return dx, dw, db


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
