"""Flash attention over ``[B, S, H, D]``, forward and backward.

The counterpart of ``paddle_tpu/ops/pallas/flash.py`` and
``paddle_tpu/ops/flash_attention.py``.  q is ``[B, Sq, H, D]``, k and v
``[B, Sk, KH, D]`` with ``H % KH == 0`` (GQA: query head ``h`` reads kv
head ``h // (H // KH)``).  With ``causal`` key ``j`` is visible from
query ``i`` when ``i + (Sk - Sq) >= j`` (the Pallas kernels' ``_mask``).

* :func:`flash_fwd` -> ``(out, lse)``: out in q's dtype, ``lse`` the f32
  log-sum-exp of each query row's scaled scores, ``[B, H, Sq]``.
* :func:`flash_bwd` -> ``(dq, dk, dv)`` from the saved ``out`` and
  ``lse`` alone (the recompute form): ``P = exp(S - lse)``,
  ``dS = P * (dO V^T - delta) * scale`` with ``delta = rowsum(dO * O)``.
* :func:`flash_attention` -> out, differentiable (an
  ``autograd.Function`` over the two).

On CUDA tensors the three hand-written kernels of
``csrc/flash_attention.cu`` run (``flash_fwd_kernel``,
``flash_bwd_dq_kernel``, ``flash_bwd_dkv_kernel``, replacing the Pallas
``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``; bf16 inputs run on
the tensor cores, the forward on the Hopper wgmma + TMA mainloop of
``csrc/attention_sm90.cuh`` and the backward on the same machinery in
``csrc/flash_bwd_sm90.cuh``, f32 inputs on the CUDA cores' FMA, all
accumulating in f32); ``delta`` is plain torch, as the JAX package
computes it in jnp outside its kernels.  Where the bf16 dK/dV kernel's
key tiles alone cannot fill the card (cross-attention over 77 keys), the
wrapper splits its query tiles into :func:`dkv_splits` contiguous ranges
whose f32 partial sums a second kernel adds in index order.  On
CPU tensors the plain twins run: the same recompute math, dense and in
f32.  Anything else raises.

A query row with no visible key (causal with ``Sq > Sk``) outputs 0 with
``lse = -inf`` and gets zero gradients, the flash-attn convention that
the JAX package's ``_sdpa_ref`` follows.

Head dims.  The kernels are instantiated at D = 64 and 128 for f32 and
at 48, 64, 80, 128 and 160 for bf16 (the LLaMA head and the SD UNet's
80 and 160).  A head dim between instantiations runs at the next one up
(:func:`kernel_head_dim`: the UNet's 40 runs at 48): the wrappers
zero-pad q, k, v (and dout) to it and slice out, dq, dk and dv back, with
``scale`` still ``1/sqrt(true D)`` from the caller.  Zero columns add 0
to every score and give zero output columns, so lse and ``delta`` are
unchanged (the JAX package pads to 128 lanes for the same reason, a TPU
rule).  A head dim above the largest instantiation raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims csrc/flash_attention.cu instantiates, per dtype
_KERNEL_HEAD_DIMS = {torch.float32: (64, 128),
                     torch.bfloat16: (48, 64, 80, 128, 160)}


def _visible(sq, sk, causal, device):
    """``[Sq, Sk]`` bool visibility, or None when every key is visible."""
    if not causal:
        return None
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    return qi + (sk - sq) >= kj


#: the card's streaming multiprocessors (H100 SXM)
_SMS = 132


def dkv_splits(b, sq, sk, kh, d):
    """Query ranges that the bf16 dK/dV kernel splits into, a pure
    function of the shape (so the sums, and the result, keep one order):
    1 while its blocks (128 keys each, 64 at a head dim above 128, times
    kv heads times batch) keep more than half of the card's 132 SMs busy
    (a block fills an SM, so splitting 67-131 blocks only adds waves);
    else the smallest power of two that gives at least two blocks an SM,
    capped by the query tiles of 64."""
    keys = 64 if kernel_head_dim(d, torch.bfloat16) > 128 else 128
    blocks = -(-sk // keys) * kh * b
    tiles = -(-sq // 64)
    if blocks == 0 or 2 * blocks > _SMS or tiles <= 1:
        return 1
    ns = 1
    while blocks * ns < 2 * _SMS:
        ns *= 2
    return min(ns, tiles)


def _expand_kv(x, groups):
    return x.to(torch.float32).repeat_interleave(groups, dim=2)


def flash_fwd_plain(q, k, v, scale, causal=False):
    """The plain twin of the forward kernel: dense f32 softmax attention.
    Differentiable by torch autograd, so it also serves as the plain
    reference of :func:`flash_attention`."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    groups = h // kh
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     _expand_kv(k, groups)) * scale
    vis = _visible(sq, sk, causal, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                       # masked keys: exactly 0
    l = p.sum(dim=-1, keepdim=True)
    any_key = l > 0
    l_safe = torch.where(any_key, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bhqd", p, _expand_kv(v, groups)) / l_safe
    lse = torch.where(any_key, m + torch.log(l_safe),
                      torch.full_like(l, float("-inf")))
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def flash_bwd_plain(q, k, v, out, lse, dout, scale, causal=False):
    """The plain twin of the two backward kernels (and of ``delta``)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    groups = h // kh
    qf, dof = q.to(torch.float32), dout.to(torch.float32)
    kf, vf = _expand_kv(k, groups), _expand_kv(v, groups)
    delta = (dof * out.to(torch.float32)).sum(-1).transpose(1, 2)  # [B,H,Sq]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    vis = _visible(sq, sk, causal, q.device)
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, kh, groups, d).sum(3)
    dv = dv.reshape(b, sk, kh, groups, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- kernels
def _fn(name, n_ptr, n_tail=2):
    """The C entry point: ``n_ptr`` pointers, six shape ints, the scale,
    ``n_tail`` ints (causal, dtype and, for dK/dV, the splits) and the
    stream."""
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * 6 + [ctypes.c_float] + \
            [i] * n_tail + [p]
        fn.restype = ctypes.c_int
    return fn


def _check_bwd(q, dout, lse, delta):
    b, sq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("flash attention kernel: dout must match q")
    for t in (lse, delta):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq):
            raise ValueError("flash attention kernel: lse and delta must "
                             f"be float32 [{b}, {h}, {sq}]")


def _check(q, k, v, *rest):
    dev = q.device
    for t in (q, k, v) + rest:
        if not t.is_cuda or t.device != dev:
            raise ValueError("flash attention kernel: inputs must be CUDA "
                             f"tensors on one device ({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention kernel: inputs must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash attention kernel: inputs must be "
                             "16-byte aligned")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel: q/k/v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype} (one of float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash attention kernel: q [B,Sq,H,D] and equal "
                         "k, v [B,Sk,KH,D]")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash attention kernel: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash attention kernel: {h} query heads over "
                         f"{k.shape[2]} kv heads")
    return b, sq, k.shape[1], h, k.shape[2], kernel_head_dim(d, q.dtype)


def kernel_head_dim(d, dtype):
    """The instantiated head dim that a ``d``-wide head runs at: the
    smallest one >= d.  Raises when there is none for the dtype."""
    for dp in _KERNEL_HEAD_DIMS.get(dtype, ()):
        if dp >= d:
            return dp
    raise ValueError(f"flash attention kernel: head_dim {d} in {dtype} "
                     f"(instantiated: {_KERNEL_HEAD_DIMS.get(dtype, ())})")


def _pad(t, dp):
    """``t`` with its last dim zero-padded to ``dp`` (itself if equal)."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


def _slice(t, d):
    """``t`` cut back to ``d`` columns (itself if equal)."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def flash_fwd_kernel(q, k, v, scale, causal=False):
    """Launch the forward kernel on the current stream -> (out, lse)."""
    b, sq, sk, h, kh, dp = _check(q, k, v)
    d = q.shape[-1]
    q, k, v = (_pad(t, dp) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            rc = _fn("flash_attention_fwd", 5)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, sq, sk, h, kh, dp, float(scale),
                int(bool(causal)), _DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(rc, "flash_fwd")
        flash_fwd_kernel.launches += 1
    return _slice(out, d), lse


def flash_bwd_dq_kernel(q, k, v, dout, lse, delta, scale, causal=False):
    """Launch the dQ kernel on the current stream -> dq."""
    b, sq, sk, h, kh, dp = _check(q, k, v, dout, lse, delta)
    _check_bwd(q, dout, lse, delta)
    d = q.shape[-1]
    q, k, v, dout = (_pad(t, dp) for t in (q, k, v, dout))
    dq = torch.empty_like(q)
    if dq.numel():
        with torch.cuda.device(q.device):
            rc = _fn("flash_attention_bwd_dq", 7)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq, sk,
                h, kh, dp, float(scale), int(bool(causal)),
                _DTYPE_CODES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(rc, "flash_bwd_dq")
        flash_bwd_dq_kernel.launches += 1
    return _slice(dq, d)


def flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, scale, causal=False):
    """Launch the dK/dV kernel on the current stream -> (dk, dv); with
    :func:`dkv_splits` > 1 its summing kernel too (one launch counted)."""
    b, sq, sk, h, kh, dp = _check(q, k, v, dout, lse, delta)
    _check_bwd(q, dout, lse, delta)
    d = q.shape[-1]
    q, k, v, dout = (_pad(t, dp) for t in (q, k, v, dout))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() and not dout.numel():        # no queries: no gradient
        dk.zero_()
        dv.zero_()
    elif dk.numel():
        ns = dkv_splits(b, sq, sk, kh, d) if q.dtype == torch.bfloat16 \
            else 1
        ws = None if ns == 1 else torch.empty(
            (2, ns, b, sk, kh, dp), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            rc = _fn("flash_attention_bwd_dkv", 9, 3)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), None if ws is None else ws.data_ptr(), b, sq,
                sk, h, kh, dp, float(scale), int(bool(causal)),
                _DTYPE_CODES[q.dtype], ns,
                torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(rc, "flash_bwd_dkv")
        flash_bwd_dkv_kernel.launches += 1
    return _slice(dk, d), _slice(dv, d)


flash_fwd_kernel.launches = 0
flash_bwd_dq_kernel.launches = 0
flash_bwd_dkv_kernel.launches = 0


# ---------------------------------------------------------------- dispatch
def flash_fwd(q, k, v, scale, causal=False):
    """(out, lse): the kernel for CUDA tensors, the plain twin for CPU."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal)
    if q.device.type == "cuda":
        return flash_fwd_kernel(q, k, v, scale, causal)
    raise ValueError(f"flash_fwd: unsupported device {q.device}")


def flash_bwd(q, k, v, out, lse, dout, scale, causal=False):
    """(dq, dk, dv): the two kernels for CUDA tensors, the plain twin for
    CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, dout, scale, causal)
    if q.device.type == "cuda":
        delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)
        delta = delta.transpose(1, 2).contiguous()            # [B, H, Sq]
        dq = flash_bwd_dq_kernel(q, k, v, dout, lse, delta, scale, causal)
        dk, dv = flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, scale,
                                      causal)
        return dq, dk, dv
    raise ValueError(f"flash_bwd: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def _scale_of(q, k, scale):
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"GQA needs q heads {q.shape[2]} divisible by kv "
                         f"heads {k.shape[2]}")
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention(q, k, v, causal=False, scale=None):
    """Attention over ``[B, S, H, D]`` (k/v may carry fewer heads), the
    flash kernels on CUDA and the plain twins on the CPU; differentiable."""
    scale = _scale_of(q, k, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, bool(causal))
    return flash_fwd(q, k, v, scale, bool(causal))[0]


def flash_attention_plain(q, k, v, causal=False, scale=None):
    """The plain twin of :func:`flash_attention` on any device,
    differentiated by torch autograd (a reference for the kernel path)."""
    return flash_fwd_plain(q, k, v, _scale_of(q, k, scale), causal)[0]
