"""The unified paged KV block pool (counterpart of
``paddle_tpu/serving/kv_cache.py``): an fp pool, or with
``quant_dtype="int8"`` an int8 pool with one f32 scale per token.

ONE per-layer ``[num_blocks, block_size, kv_heads, head_dim]`` k/v
pool is shared by every slot and addressed through a per-slot block
table.  Decode attention reads only the table-mapped blocks below each
row's length (ragged).  Block 0 is reserved scratch: padding lanes,
zeroed rows of retired slots and writes past a table's coverage all
land there, where colliding garbage writes are harmless by convention.

Unlike the JAX package, whose arrays are immutable, :func:`paged_write`
and :func:`paged_write_quant` write into the pool IN PLACE
(``pool[blocks, offs] = new``) and return the same tensors: the pool is
the largest allocation of a serving run and is never copied.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class PagedKV:
    """One layer's paged-cache view for a batch of lanes.

    k, v:    [num_blocks, block_size, kv_heads, head_dim] — the layer's
             pool (block 0 is reserved scratch)
    tables:  [batch, nb] int32 block table — entry j maps positions
             ``j*block_size .. (j+1)*block_size-1`` of a lane to a pool
             block; 0 marks an unallocated entry (scratch)
    pos:     [batch] int32 — tokens already cached per lane; incoming
             tokens are written at positions pos .. pos+s-1 and attend
             over keys 0 .. pos+s-1
    k_scale, v_scale: [num_blocks, block_size] f32 per-token scales of
             an int8 pool (None for an fp pool)
    """

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor
    pos: torch.Tensor
    k_scale: torch.Tensor = None
    v_scale: torch.Tensor = None

    @property
    def block_size(self):
        return self.k.shape[1]


def _write_coords(bs, s, tables, pos):
    """Per-token (block, offset) scatter coordinates [B, s] for a write
    of ``s`` tokens at per-lane positions ``pos`` through ``tables``.
    Positions past the table's coverage resolve to block 0 (scratch)."""
    tpos = pos[:, None].long() + torch.arange(s, device=pos.device)
    blk_idx = tpos // bs
    in_range = blk_idx < tables.shape[1]
    blk_idx = blk_idx.clamp(0, tables.shape[1] - 1)
    blocks = torch.gather(tables.long(), 1, blk_idx)
    blocks = torch.where(in_range, blocks, torch.zeros_like(blocks))
    return blocks, tpos % bs


def paged_write(pool, new, tables, pos):
    """Scatter ``new`` [B, s, H, D] into ``pool`` [NB, bs, H, D] in place
    at per-lane positions ``pos`` [B] through ``tables`` [B, nb]; returns
    ``pool``."""
    b, s = new.shape[0], new.shape[1]
    blocks, offs = _write_coords(pool.shape[1], s, tables, pos)
    pool[blocks.reshape(-1), offs.reshape(-1)] = \
        new.reshape((b * s,) + tuple(new.shape[2:])).to(pool.dtype)
    return pool


#: symmetric int8 range of a quantized KV token
KV_QMAX = 127.0


def paged_write_quant(pool, scales, new, tables, pos):
    """Quantize-at-append: scatter ``new`` [B, s, H, D] into the int8
    ``pool`` [NB, bs, H, D] in place, with one f32 absmax scale per
    token written beside it into ``scales`` [NB, bs]; returns ``(pool,
    scales)``.  Per token, not per block: a token's stored bytes are a
    pure function of its own k/v vector (write-once), so decode's
    one-token appends, a prefill window and a preemption's re-prefill
    store the same bytes.  The floor ``max(absmax, 1e-8)`` makes an
    all-zero vector (scratch writes, padding lanes) quantize to exact
    zeros, as the fp pool's zero-initialized blocks."""
    b, s = new.shape[0], new.shape[1]
    blocks, offs = _write_coords(pool.shape[1], s, tables, pos)
    x = new.float()
    absmax = x.abs().amax(dim=(2, 3))                          # [B, s]
    step = absmax.clamp_min(1e-8) / KV_QMAX
    q = torch.round(x / step[..., None, None]).clamp(-KV_QMAX, KV_QMAX)
    bi, oi = blocks.reshape(-1), offs.reshape(-1)
    pool[bi, oi] = q.to(pool.dtype).reshape((b * s,) + tuple(new.shape[2:]))
    scales[bi, oi] = step.reshape(-1)
    return pool, scales


class PagedKVPool:
    """The refcounted block pool: per layer one k and one v buffer of
    ``[num_blocks, block_size, kv_heads, head_dim]``.  Block 0 is pinned
    scratch; every other block is tracked by a host refcount and returns
    to the free list when its last reference is released.  The buffers
    live on the CUDA card unless ``device="cpu"`` is asked for (see
    :func:`~paddle_tpu_torch.resolve_device`).

    ``quant_dtype="int8"`` stores the blocks in int8 with a per-layer
    ``[num_blocks, block_size]`` f32 scale buffer beside each k and v
    buffer (:func:`paged_write_quant` fills both; attention dequantizes
    token-wise).  The block bookkeeping is the same: it moves block ids,
    not bytes."""

    def __init__(self, num_layers, num_blocks, block_size, kv_heads,
                 head_dim, dtype=torch.float32, device=None,
                 quant_dtype=None):
        if num_blocks < 2:
            raise ValueError("paged pool needs >= 2 blocks (one scratch)")
        if quant_dtype not in (None, "int8"):
            raise ValueError(f"unsupported KV quant_dtype {quant_dtype!r} "
                             "(supported: None, 'int8')")
        device = resolve_device(device)
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.quant_dtype = quant_dtype
        self.store_dtype = torch.int8 if quant_dtype else dtype
        shape = (num_blocks, block_size, kv_heads, head_dim)
        self.k = [torch.zeros(shape, dtype=self.store_dtype, device=device)
                  for _ in range(num_layers)]
        self.v = [torch.zeros(shape, dtype=self.store_dtype, device=device)
                  for _ in range(num_layers)]
        self.k_scale = self.v_scale = None
        if quant_dtype:
            # zero scales dequantize the zero-initialized blocks to the
            # exact 0.0 the fp pool starts with
            sshape = (num_blocks, block_size)
            self.k_scale = [torch.zeros(sshape, device=device)
                            for _ in range(num_layers)]
            self.v_scale = [torch.zeros(sshape, device=device)
                            for _ in range(num_layers)]
        self._refs = np.zeros(num_blocks, np.int32)
        self._refs[0] = 1                    # scratch: pinned forever
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def capacity(self):
        """Allocatable blocks (excludes the scratch block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def blocks_in_use(self):
        return self.capacity - len(self._free)

    @property
    def bytes_per_block(self):
        """Device bytes per block across k+v and every layer: the payload
        at the storage dtype plus, when quantized, the 4-byte scale of
        each token."""
        return 2 * self.num_layers * self.block_size * token_bytes(
            self.kv_heads, self.head_dim, self.store_dtype, self.quant_dtype)

    def alloc(self):
        """Claim a free block (refcount 1), or None when exhausted."""
        if not self._free:
            return None
        bid = self._free.pop()
        self._refs[bid] = 1
        return bid

    def share(self, block_id):
        """Take one more reference on a live block."""
        if self._refs[block_id] <= 0:
            raise ValueError(f"block {block_id} shared while free")
        self._refs[block_id] += 1

    def release(self, block_id):
        """Drop one reference; the block returns to the free list when
        the last holder lets go.  Block 0 (scratch) is never released."""
        if block_id == 0:
            return
        if self._refs[block_id] <= 0:
            raise ValueError(f"block {block_id} over-released")
        self._refs[block_id] -= 1
        if self._refs[block_id] == 0:
            self._free.append(block_id)

    def refcount(self, block_id):
        return int(self._refs[block_id])


def token_bytes(kv_heads, head_dim, dtype, quant_dtype=None):
    """Bytes one token of one layer's k (or v) takes in a pool of
    ``dtype``, or in an int8 pool with its f32 scale."""
    if quant_dtype:
        return kv_heads * head_dim + 4
    return kv_heads * head_dim * torch.empty((), dtype=dtype).element_size()


class PagedKVCache:
    """Engine-side owner of the paged cache: the pool, the per-slot
    block tables (host ``np.int32``, authoritative) and the slot
    free-list.  Entries are filled lazily: admission covers the prompt
    (leasing prefix-cache hits, allocating the rest), :meth:`ensure_blocks`
    extends coverage to each horizon's write window, retirement and
    preemption release every entry back to the pool.  The auto-sized
    pool (``num_blocks=0``) holds a full row per slot plus
    ``extra_blocks`` of prefix-store headroom."""

    def __init__(self, num_layers, num_slots, max_seq_len, block_size,
                 kv_heads, head_dim, dtype=torch.float32, num_blocks=0,
                 extra_blocks=0, device=None, quant_dtype=None):
        self.num_layers = num_layers
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.max_blocks_per_slot = -(-max_seq_len // block_size)
        if num_blocks <= 0:
            # auto: every slot can grow to a full row, plus headroom for
            # the prefix store, plus the scratch block
            num_blocks = (1 + num_slots * self.max_blocks_per_slot
                          + extra_blocks)
        self.pool = PagedKVPool(num_layers, num_blocks, block_size,
                                kv_heads, head_dim, dtype, device,
                                quant_dtype)
        self.tables = np.zeros((num_slots, self.max_blocks_per_slot),
                               np.int32)
        self.tables_dirty = True
        self._free = list(range(num_slots - 1, -1, -1))

    # ---------------- slot bookkeeping (host side)
    def alloc(self):
        """Claim a free slot index, or None when every slot is taken."""
        return self._free.pop() if self._free else None

    def free(self, slot):
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)

    @property
    def free_slots(self):
        return len(self._free)

    @property
    def used_slots(self):
        return self.num_slots - len(self._free)

    # ---------------- block-table bookkeeping (host side)
    def lease_block(self, slot, index, block_id):
        """Map a SHARED pool block (a prefix-cache hit) into a slot's
        table: the table entry takes its own reference."""
        self.pool.share(block_id)
        self.tables[slot, index] = block_id
        self.tables_dirty = True

    def alloc_entry(self, slot, index):
        """Fill one table entry with a fresh private block; returns the
        block id or None when the pool is exhausted."""
        bid = self.pool.alloc()
        if bid is None:
            return None
        self.tables[slot, index] = bid
        self.tables_dirty = True
        return bid

    def ensure_blocks(self, slot, n_tokens):
        """Extend a slot's table to cover ``n_tokens`` positions (only
        entries still 0 are allocated).  Returns False, keeping any
        partial allocation, when the pool runs dry."""
        need = min(-(-n_tokens // self.block_size),
                   self.max_blocks_per_slot)
        for j in range(need):
            if self.tables[slot, j] == 0:
                if self.alloc_entry(slot, j) is None:
                    return False
        return True

    def release_slot_blocks(self, slot):
        """Release every table entry of a slot (retirement, preemption):
        shared blocks live on while other holders remain, private ones
        return to the pool.  The zeroed row routes any later masked-lane
        writes to scratch."""
        row = self.tables[slot]
        for j in np.nonzero(row)[0]:
            self.pool.release(int(row[j]))
        row[:] = 0
        self.tables_dirty = True

    @property
    def leased_blocks(self):
        """Live (slot, entry) references across all block tables."""
        return int(np.count_nonzero(self.tables))

    def copy_blocks(self, src, dst):
        """Copy-on-write: ``pool[dst[i]] = pool[src[i]]`` in every
        layer's k and v pool (and an int8 pool's scales), one indexed
        assignment per buffer, for the device index vectors
        ``src``/``dst``.  Pairs 0/0 copy scratch onto itself (duplicate
        destinations then write equal values).  The gather materialises
        before the scatter, and both run on the current stream ahead of
        whatever is queued next."""
        pool = self.pool
        for buf in pool.k + pool.v + (pool.k_scale or []) + (
                pool.v_scale or []):
            buf[dst] = buf[src]

    def layer_views(self, tables, pos):
        """Per-layer PagedKV views over device tensors ``tables``/``pos``."""
        p = self.pool
        return [PagedKV(p.k[i], p.v[i], tables, pos,
                        p.k_scale[i] if p.quant_dtype else None,
                        p.v_scale[i] if p.quant_dtype else None)
                for i in range(self.num_layers)]
