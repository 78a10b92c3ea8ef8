"""Ragged paged attention over the unified KV block pool.

Layout contract (as ``paddle_tpu/serving/paged_attention.py``): q
``[B, s, QH, D]``, pools ``[NB, bs, KH, D]`` with GQA group size
``G = QH // KH`` (query head ``h`` reads kv head ``h // G``), tables
``[B, nb]`` int32 (0 = scratch), pos ``[B]`` int32.  Query row ``r`` of
lane ``b`` sits at absolute position ``pos[b] + r`` and sees the keys at
positions ``<= pos[b] + r`` (write-before-attend).  Returns
``[B, s, QH, D]`` in q's dtype.

:func:`paged_attention` runs the hand-written CUDA kernels of
``csrc/paged_attention.cu`` (which replace the Pallas kernel
``_paged_attn_kernel``) for CUDA tensors and the plain PyTorch version
for CPU tensors; anything else raises.  A bf16 or float16 query runs
the Hopper tensor-core kernel (the wgmma + TMA mainloop of
``csrc/attention_sm90.cuh``) over a pool of its dtype and over an int8
pool alike, for every window, decode and prefill: it walks fixed 64-key
tiles from key 0, so an output row's bits depend only on its q vector
and its visible keys, not on the window length, the lane count, ``nb``
or the row's place in its tile.  Over an int8 pool its TMA boxes bring
int8 K/V and the scales, idle producer warps convert them to the query's
dtype (exactly: they are integers) and the scales multiply the scores and the
probabilities in f32.  An f32 query (over an f32 or an int8 pool) runs
the FMA kernel, the precision check.

The plain version is the same per-table-column online-softmax recurrence
as the JAX reference ``_xla_paged_attention``, not a dense masked
softmax: a column with no visible keys leaves the state bitwise
unchanged (its scores sit at the finite ``NEG_INF`` floor, so ``m`` is
unchanged; its probabilities are a literal 0.0, so ``l`` and ``acc``
pass through), which makes the output invariant to the number of table
columns ``nb``.

``k_scale``/``v_scale`` ([NB, bs] f32, or None) mark an int8 pool: each
gathered block is dequantized token-wise (``block.float() * scale``)
before the softmax math (the CUDA kernel folds the scales into the
softmax instead, see above).  On the card an int8 pool's launches count on
:data:`int8_pool` (``kernel_launches()["paged_attention_int8"]``), the
others on ``paged_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import torch

from .. import _build

NEG_INF = -1e30      # finite floor: keeps exp(s - m) NaN-free when a
#                      query row has no visible key in a block

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_BLOCK_SIZE = 16
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_MAX_GROUP = 64      # a 64-vector tile holds one row of every group head


def paged_attention_plain(q, k_pool, v_pool, tables, pos,
                          k_scale=None, v_scale=None):
    """The plain PyTorch version: one online-softmax step per table
    column, f32 throughout."""
    b, s, qh, d = q.shape
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    g = qh // kh
    nb = tables.shape[1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    tables = tables.long()

    qg = (q.to(torch.float32) * scale).reshape(b, s, kh, g, d)
    q_pos = pos.long()[:, None] + torch.arange(s, device=dev)    # [B, s]
    m = torch.full((b, s, kh, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, kh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, kh, g, d), dtype=torch.float32, device=dev)
    offs = torch.arange(bs, device=dev)
    for i in range(nb):
        blocks = tables[:, i]                                      # [B]
        kb = k_pool[blocks].to(torch.float32)                      # [B,bs,KH,D]
        vb = v_pool[blocks].to(torch.float32)
        if k_scale is not None:
            kb = kb * k_scale[blocks][:, :, None, None]
            vb = vb * v_scale[blocks][:, :, None, None]
        sc = torch.einsum("bskgd,btkd->bskgt", qg, kb)
        vis = (i * bs + offs)[None, None, :] <= q_pos[:, :, None]  # [B,s,bs]
        vis = vis[:, :, None, None, :]
        sc = torch.where(vis, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # exact-zero masked probabilities (not exp(NEG_INF - m))
        p = torch.where(vis, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + \
            torch.einsum("bskgt,btkd->bskgd", p, vb)
        m = m_new
    # every query row sees at least key 0, so l > 0
    out = acc / l[..., None]
    return out.reshape(b, s, qh, d).to(q.dtype)


def check_kernel_geometry(block_size, num_heads, kv_heads, head_dim,
                          dtype):
    """Raise if the CUDA kernel cannot take a pool of this geometry.  The
    kernel wrapper checks every call with it, and the serving engine
    when it is built on the card, so a block size, head dim, GQA group
    or dtype outside the kernel's range fails there and not at the
    first forward (nothing falls back)."""
    if block_size != _KERNEL_BLOCK_SIZE:
        raise ValueError(f"paged_attention kernel: block_size {block_size} "
                         f"(supported: {_KERNEL_BLOCK_SIZE})")
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {head_dim} "
                         f"(supported: {_KERNEL_HEAD_DIMS})")
    if num_heads % kv_heads or num_heads // kv_heads > _KERNEL_MAX_GROUP:
        raise ValueError(f"paged_attention kernel: {num_heads} query heads "
                         f"over {kv_heads} kv heads (a group of at most "
                         f"{_KERNEL_MAX_GROUP})")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_attention kernel: dtype {dtype} "
                        "(float32, bfloat16 or float16)")


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention_kernel(q, k_pool, v_pool, tables, pos,
                           k_scale=None, v_scale=None):
    """Launch the CUDA kernel on the current stream.  Raises on any
    input it does not take: devices, dtypes, contiguity, shapes."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("paged_attention: k_scale and v_scale go together")
    tensors = [q, k_pool, v_pool, tables, pos]
    if quant:
        tensors += [k_scale, v_scale]
    dev = q.device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError("paged_attention kernel: inputs must be CUDA "
                             f"tensors on one device ({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention kernel: inputs must be "
                             "contiguous")
    pool_dtype = torch.int8 if quant else q.dtype
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"paged_attention kernel: pools must be "
                        f"{pool_dtype} for a {q.dtype} query"
                        + (" with scales" if quant else ""))
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError("paged_attention kernel: q [B,s,QH,D] and equal "
                         "pools [NB,bs,KH,D]")
    b, s, qh, d = q.shape
    num_blocks, bs, kh, dk = k_pool.shape
    if dk != d:
        raise ValueError(f"paged_attention kernel: head_dim {d} / pool "
                         f"{dk}")
    check_kernel_geometry(bs, qh, kh, d, q.dtype)
    if (tables.dtype != torch.int32 or tables.dim() != 2
            or tables.shape[0] != b or tables.shape[1] < 1):
        raise ValueError("paged_attention kernel: tables must be int32 "
                         f"[{b}, nb >= 1], got {tables.dtype} "
                         f"{tuple(tables.shape)}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,):
        raise ValueError(f"paged_attention kernel: pos must be int32 [{b}]")
    if quant and (k_scale.dtype != torch.float32
                  or tuple(k_scale.shape) != (num_blocks, bs)
                  or v_scale.shape != k_scale.shape
                  or v_scale.dtype != torch.float32):
        raise ValueError("paged_attention kernel: scales must be float32 "
                         f"[{num_blocks}, {bs}]")
    if any(t.data_ptr() % 16 for t in tensors[1:3] + tensors[5:]):
        raise ValueError("paged_attention kernel: pools and scales must be "
                         "16-byte aligned")
    out = torch.empty_like(q)
    if b and s:
        with torch.cuda.device(dev):
            rc = _lib()(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None,
                tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                b, s, qh, kh, d, bs, tables.shape[1], num_blocks,
                _DTYPE_CODES[q.dtype], int(quant),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"paged_attention kernel launch failed: "
                               f"CUDA error {rc}")
        (int8_pool if quant else paged_attention).launches += 1
    return out


def paged_attention(q, k_pool, v_pool, tables, pos,
                    k_scale=None, v_scale=None):
    """Ragged paged attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, pos,
                                     k_scale, v_scale)
    if q.device.type == "cuda":
        return paged_attention_kernel(q, k_pool, v_pool, tables, pos,
                                      k_scale, v_scale)
    raise ValueError(f"paged_attention: unsupported device {q.device}")


paged_attention.launches = 0
#: launch count of the int8-pool variants (the tensor-core kernel for a
#: bf16 query, the FMA kernel for an f32 one, over an int8 pool with
#: per-token scales)
int8_pool = SimpleNamespace(launches=0)
