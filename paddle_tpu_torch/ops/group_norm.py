"""GroupNorm over the NC* layout, forward and backward.  x is
``[N, C, *spatial]`` with ``C % G == 0``; each (sample, group) is one row
of ``Cg * HW`` elements (``Cg = C / G``, ``HW`` the spatial size), and
``y = (x - mean) * rstd * w[c] + b[c]`` with the row's f32 ``mean`` and
``rstd = rsqrt(mean((x - mean)^2) + eps)``, y in x's dtype.

Replaces the Pallas kernels ``_gn_fwd_kernel`` (launched by
``_gn_call_fwd``) and ``_gn_bwd_kernel`` (launched by ``_gn_vjp_bwd``),
``paddle_tpu/ops/pallas/norms.py:304, :366`` and ``:318, :424``.

* forward, a Triton kernel with one program per (sample, group) row.
  The rows are long (up to 30 x 4096 = 122,880 elements in the SD UNet)
  and few (``N * G``, 128 at batch 4), so a row never fits in registers:
  each program walks it in ``[BLOCK_C, BLOCK_HW]`` tiles, channels down
  and spatial positions across, so the per-channel weight and bias are
  a ``[BLOCK_C]`` vector read once per tile (the TPU kernel instead
  reads a broadcast ``[G, Cg * HW]`` copy of them from HBM); three
  passes over the row: the sum, then the sum of ``(x - mean)^2`` (two
  passes, not ``E[x^2] - mean^2``, which cancels at 10^5 elements with a
  large mean), then y.  The row is re-read from L2 on the second and
  third pass: 128 rows of at most 240 KB (bf16) fit the 50 MB L2.
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
from .layer_norm import DTYPE_CODES

#: ``triton.language``, bound at the first launch (triton is imported
#: only when a kernel is launched, so this module imports without it)
tl = None
_KERNELS = {}
_TILE = 4096           # elements of one [BLOCK_C, BLOCK_HW] tile
#: the backward's geometry (``csrc/norms.cu``): warps a CTA, CTAs a
#: cluster at most (the portable cluster size), rows of chunks a CTA holds
#: in mode 0 (one summed, one awaiting its dx, one loading)
GN_WARPS, GN_MAX_CLUSTER, GN_STAGES = 8, 8, 3
#: dynamic shared memory a CTA may ask for: the H100's 227 KB per block
#: less room for the kernel's static shared memory
SMEM_MAX = 232448 - 128
#: the largest x + g chunk the plan gives a CTA where the row splits
#: finer (a CTA holds GN_STAGES of them)
CHUNK_TARGET = 64 * 1024
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
    "group_norm_bwd": [_P] * 10 + [_I] * 10 + [_P],
    "group_norm_bwd_max_clusters": [_I] * 4 + [ctypes.POINTER(_I)],
}
_MAX_CLUSTERS = {}


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


def _fwd_kernel():
    global tl
    if not _KERNELS:
        import triton
        import triton.language as tl
        _KERNELS["fwd"] = triton.jit(_gn_fwd)
    return _KERNELS["fwd"]


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
        _fwd_kernel()[(rows,)](
            x, weight, bias, y, mean, rstd, num_groups, cg, hw, float(eps),
            BLOCK_C=block_c, BLOCK_HW=block_hw, num_warps=warps)
        group_norm.launches += 1
    return y, mean, rstd


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


def _max_clusters(lib, device, code, mode, s, smem):
    key = (device.index, code, mode, s, smem)
    if key not in _MAX_CLUSTERS:
        out = ctypes.c_int(0)
        rc = lib.group_norm_bwd_max_clusters(code, mode, s, smem,
                                             ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"group_norm_bwd occupancy query failed: CUDA "
                               f"error {rc}")
        _MAX_CLUSTERS[key] = out.value
    return _MAX_CLUSTERS[key]


def group_norm_bwd_kernel(x, weight, mean, rstd, g, num_groups):
    """Launch the CUDA backward on the current stream -> (dx, dw, db)."""
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
    dx = torch.empty_like(x)
    if not x.numel():
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    dev, code = x.device, DTYPE_CODES[x.dtype]
    ws = torch.empty((n, 2, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _lib()
        plan = group_norm_bwd_plan(
            n, c, num_groups, hw, x.element_size(),
            all(t.data_ptr() % 16 == 0 for t in (x, g, dx)),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            lambda mode, s, smem: _max_clusters(lib, dev, code, mode, s,
                                                smem))
        rc = lib.group_norm_bwd(
            x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            db.data_ptr(), ws.data_ptr(), _build.ticket(dev).data_ptr(), n, c,
            num_groups, hw, code, DTYPE_CODES[weight.dtype], plan["mode"],
            plan["cluster"], plan["clusters"], plan["smem"],
            torch.cuda.current_stream(dev).cuda_stream)
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
