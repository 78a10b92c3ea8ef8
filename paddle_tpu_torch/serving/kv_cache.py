"""The unified paged KV block pool (counterpart of
``paddle_tpu/serving/kv_cache.py``, fp pool only).

ONE per-layer ``[num_blocks, block_size, kv_heads, head_dim]`` k/v
pool is shared by every slot and addressed through a per-slot block
table.  Decode attention reads only the table-mapped blocks below each
row's length (ragged).  Block 0 is reserved scratch: padding lanes,
zeroed rows of retired slots and writes past a table's coverage all
land there, where colliding garbage writes are harmless by convention.

Unlike the JAX package, whose arrays are immutable, :func:`paged_write`
writes into the pool IN PLACE (``pool[blocks, offs] = new``) and
returns the same tensor: the pool is the largest allocation of a
serving run and is never copied.
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
    """

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor
    pos: torch.Tensor

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


class PagedKVPool:
    """The refcounted block pool: per layer one k and one v buffer of
    ``[num_blocks, block_size, kv_heads, head_dim]``.  Block 0 is pinned
    scratch; every other block is tracked by a host refcount and returns
    to the free list when its last reference is released.  The buffers
    live on the CUDA card unless ``device="cpu"`` is asked for (see
    :func:`~paddle_tpu_torch.resolve_device`)."""

    def __init__(self, num_layers, num_blocks, block_size, kv_heads,
                 head_dim, dtype=torch.float32, device=None):
        if num_blocks < 2:
            raise ValueError("paged pool needs >= 2 blocks (one scratch)")
        device = resolve_device(device)
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        shape = (num_blocks, block_size, kv_heads, head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
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
        """Device bytes per block across k+v and every layer."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (2 * self.num_layers * self.block_size * self.kv_heads
                * self.head_dim * itemsize)

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


class PagedKVCache:
    """Engine-side owner of the paged cache: the pool, the per-slot
    block tables (host ``np.int32``, authoritative) and the slot
    free-list.  Entries are filled lazily: admission covers the prompt,
    :meth:`ensure_blocks` extends coverage to each horizon's write
    window, retirement releases every entry back to the pool."""

    def __init__(self, num_layers, num_slots, max_seq_len, block_size,
                 kv_heads, head_dim, dtype=torch.float32, num_blocks=0,
                 device=None):
        self.num_layers = num_layers
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.max_blocks_per_slot = -(-max_seq_len // block_size)
        if num_blocks <= 0:
            # auto: every slot can grow to a full row, plus scratch
            num_blocks = 1 + num_slots * self.max_blocks_per_slot
        self.pool = PagedKVPool(num_layers, num_blocks, block_size,
                                kv_heads, head_dim, dtype, device)
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

    # ---------------- block-table bookkeeping (host side)
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
        """Release every table entry of a slot; the zeroed row routes
        any later masked-lane writes to scratch."""
        row = self.tables[slot]
        for j in np.nonzero(row)[0]:
            self.pool.release(int(row[j]))
        row[:] = 0
        self.tables_dirty = True

    @property
    def leased_blocks(self):
        """Live (slot, entry) references across all block tables."""
        return int(np.count_nonzero(self.tables))

    def layer_views(self, tables, pos):
        """Per-layer PagedKV views over device tensors ``tables``/``pos``."""
        return [PagedKV(self.pool.k[i], self.pool.v[i], tables, pos)
                for i in range(self.num_layers)]
