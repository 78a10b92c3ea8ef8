"""Host-RAM spill arena under the unified paged KV pool (the port's
counterpart of ``paddle_tpu/serving/kv_host_tier.py``): the tier that
turns eviction and preemption from "recompute it" into "copy it back".

The arena holds copies of

* **demoted prefix blocks** — ``PrefixCache`` eviction hands the
  victim's full token path and block bytes here instead of dropping
  them, so the prefix store stretches from device memory into host RAM;
  and
* **preempted lane images** — ``Engine.preempt`` saves the lane's whole
  block chain keyed by request id, so re-admission re-binds the blocks
  with one batched host→device upload instead of re-prefilling.

Bitwise safety is inherited: the stored bytes are exactly the bytes the
device pool held (for int8 pools, payload and per-token f32 scales), so
a host round trip is indistinguishable from recompute, and the engine's
resume check (the re-sampled boundary token must equal the streamed
one) doubles as the parity gate.

Layout: ``k``/``v`` are ``[capacity, num_layers, block_size, kv_heads,
head_dim]`` torch CPU tensors at the pool's storage dtype (numpy has no
bfloat16), plus ``[capacity, num_layers, block_size]`` f32 scale planes
for an int8 pool: one host block mirrors one device block across every
layer.  ``capacity`` is ``budget_bytes // bytes_per_block`` with the
DEVICE pool's ``bytes_per_block``, so the budget means the same on both
tiers.  With ``pin_memory=True`` (the engine asks for it when the pool
is on the card) the arena is page-locked: device→host copies into it
are asynchronous on the issuing stream, where an unpinned arena would
make every one synchronous.

Ordering on the card: a block written from a device tensor is copied on
the current stream (``non_blocking``), so a later kernel that rewrites
the source pool block is ordered after the copy, and so is an upload
that reads the row back.  Host code that READS arena bytes
(:meth:`read_block`, the staged path of :meth:`gather`) first waits for
the last pending copy, counted in ``stats()["host_syncs"]``.

Retention (as the JAX tier): host blocks are refcounted.  Prefix entries
are LRU-evictable except while pinned by :meth:`pin_prefix` (the window
between ``match_prefix`` and ``pop_prefix`` of a swap-in); lane images
are pinned until consumed, invalidated (abort, retire) or cleared, and
``save_lane`` evicts prefix entries to make room or fails cleanly (the
engine then recomputes).

Thread ownership: engine-owned state, mutated only from the thread that
drives the engine; no locks.
"""

from __future__ import annotations

import numpy as np
import torch


class _LaneImage:
    """A preempted lane's full KV block chain: ``hbs`` host blocks
    covering ``n_tokens`` positions (the last block may be partial —
    its trailing bytes are garbage the resume path never reads)."""

    __slots__ = ("hbs", "n_tokens")

    def __init__(self, hbs, n_tokens):
        self.hbs = list(hbs)
        self.n_tokens = int(n_tokens)


class _PrefixEntry:
    """One demoted radix block: ``hb`` holds the KV for the LAST
    ``block_size`` tokens of ``path`` (the full token path from the
    radix root, also the key it is indexed under).  ``pinned`` counts
    in-flight swap-ins shielding it from arena-level LRU eviction."""

    __slots__ = ("hb", "path", "last_used", "pinned")

    def __init__(self, hb, path, clock):
        self.hb = hb
        self.path = path
        self.last_used = clock
        self.pinned = 0


class HostKVTier:
    """The host arena: a refcounted block index over preallocated torch
    CPU payload tensors, with a prefix index (token path -> entry,
    LRU-evictable) and a lane-image index (request id -> pinned chain).

    Payload setters and getters move raw block bytes; the engine owns
    which device blocks map to which host blocks and when."""

    def __init__(self, num_layers, block_size, kv_heads, head_dim,
                 store_dtype, budget_bytes, bytes_per_block,
                 quantized=False, pin_memory=False):
        self.num_layers = int(num_layers)
        self.block_size = int(block_size)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.store_dtype = store_dtype
        self.quantized = bool(quantized)
        self.bytes_per_block = int(bytes_per_block)
        self.budget_bytes = int(budget_bytes)
        self.capacity = max(0, self.budget_bytes // self.bytes_per_block)
        shape = (self.capacity, self.num_layers, self.block_size,
                 self.kv_heads, self.head_dim)
        pin = bool(pin_memory) and self.capacity > 0
        self.k = torch.zeros(shape, dtype=store_dtype, pin_memory=pin)
        self.v = torch.zeros(shape, dtype=store_dtype, pin_memory=pin)
        if self.quantized:
            sshape = (self.capacity, self.num_layers, self.block_size)
            self.k_scale = torch.zeros(sshape, pin_memory=pin)
            self.v_scale = torch.zeros(sshape, pin_memory=pin)
        else:
            self.k_scale = self.v_scale = None
        self._refs = np.zeros(self.capacity, np.int32)
        self._free = list(range(self.capacity - 1, -1, -1))
        self._prefix = {}            # token path tuple -> _PrefixEntry
        self._lanes = {}             # request_id -> _LaneImage
        self._clock = 0
        self._pending = None         # CUDA event after the last async copy
        # counters (the engine surfaces them through stats())
        self.demotions = 0           # prefix blocks accepted from eviction
        self.demotions_dropped = 0   # spills refused (arena full)
        self.promotions = 0          # prefix blocks swapped back in
        self.lane_saves = 0
        self.lane_restores = 0
        self.lane_drops = 0          # images invalidated unconsumed
        self.prefix_evictions = 0    # arena-level LRU drops
        self.host_syncs = 0          # waits before host reads of the arena

    # ------------------------------------------------------ block index
    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def blocks_in_use(self):
        return self.capacity - len(self._free)

    @property
    def bytes_in_use(self):
        return self.blocks_in_use * self.bytes_per_block

    @property
    def occupancy(self):
        return (self.blocks_in_use / self.capacity
                if self.capacity else 0.0)

    @property
    def nbytes(self):
        """Host bytes of the arena's payload (allocated in full at
        construction)."""
        bufs = [self.k, self.v] + ([self.k_scale, self.v_scale]
                                   if self.quantized else [])
        return sum(b.numel() * b.element_size() for b in bufs)

    def is_pinned(self):
        """True when the payload tensors are page-locked."""
        return self.capacity > 0 and self.k.is_pinned() \
            and self.v.is_pinned()

    def _alloc(self):
        """Claim a free host block (refcount 1), evicting LRU prefix
        entries if the free list is dry; None when even that fails
        (everything left is pinned lane images)."""
        if not self._free and not self._evict_lru_prefix():
            return None
        hb = self._free.pop()
        self._refs[hb] = 1
        return hb

    def release(self, hb):
        """Drop one reference; the block returns to the free list when
        the last holder lets go."""
        if self._refs[hb] <= 0:
            raise ValueError(f"host block {hb} over-released")
        self._refs[hb] -= 1
        if self._refs[hb] == 0:
            self._free.append(hb)

    def _evict_lru_prefix(self):
        """Drop the least-recently-used unpinned prefix entry (lane
        images and entries under a :meth:`pin_prefix` hold are never
        victims).  Returns True if one was freed."""
        victim = min((e for e in self._prefix.values() if not e.pinned),
                     key=lambda e: e.last_used, default=None)
        if victim is None:
            return False
        del self._prefix[victim.path]
        self.release(victim.hb)
        self.prefix_evictions += 1
        return True

    def _write_block(self, hb, kd, vd, ksd=None, vsd=None):
        """Copy one block's payload into row ``hb``: asynchronously on
        the current stream when it comes from the card (the row is
        pinned), else a plain host copy."""
        async_copy = kd.is_cuda
        self.k[hb].copy_(kd, non_blocking=async_copy)
        self.v[hb].copy_(vd, non_blocking=async_copy)
        if self.quantized:
            self.k_scale[hb].copy_(ksd, non_blocking=async_copy)
            self.v_scale[hb].copy_(vsd, non_blocking=async_copy)
        if async_copy:
            self._pending = torch.cuda.Event()
            self._pending.record()

    def _await(self):
        """Wait for the arena's pending device→host copies before host
        code reads its bytes."""
        if self._pending is not None:
            self._pending.synchronize()
            self._pending = None
            self.host_syncs += 1

    def read_block(self, hb):
        """(k, v, k_scale, v_scale) views of one host block (scale
        planes None on fp arenas), after any pending copy landed."""
        self._await()
        if self.quantized:
            return (self.k[hb], self.v[hb],
                    self.k_scale[hb], self.v_scale[hb])
        return self.k[hb], self.v[hb], None, None

    def gather(self, hbs):
        """Host blocks ``hbs`` stacked in order: ``(k, v, k_scale,
        v_scale)`` as ``[n, num_layers, block_size, kv_heads, head_dim]``
        (scales ``[n, num_layers, block_size]``, None on fp arenas), in
        page-locked memory when the arena is, so the engine's swap-in
        uploads each with ONE host→device copy.  A run of consecutive
        blocks (a lane image saved into a free list that hands out
        ascending rows) is returned as views of the arena: the upload
        reads it on the stream the arena's copies were issued on, so
        neither a host copy nor a wait is needed.  Otherwise the rows
        are copied into fresh buffers, after any pending copy landed."""
        hbs = [int(h) for h in hbs]
        if hbs and hbs == list(range(hbs[0], hbs[0] + len(hbs))):
            run = slice(hbs[0], hbs[0] + len(hbs))
            if self.quantized:
                return (self.k[run], self.v[run], self.k_scale[run],
                        self.v_scale[run])
            return self.k[run], self.v[run], None, None
        self._await()
        idx = torch.tensor(hbs, dtype=torch.long)
        pin = self.k.is_pinned()

        def take(buf):
            out = torch.empty((len(idx),) + tuple(buf.shape[1:]),
                              dtype=buf.dtype, pin_memory=pin)
            return torch.index_select(buf, 0, idx, out=out)

        if self.quantized:
            return (take(self.k), take(self.v), take(self.k_scale),
                    take(self.v_scale))
        return take(self.k), take(self.v), None, None

    # ---------------------------------------------------- prefix spills
    def store_prefix(self, path, kd, vd, ksd=None, vsd=None):
        """Accept one demoted radix block: ``path`` is the FULL token
        path from the radix root through this block (the re-match key),
        ``kd``/``vd`` the ``[num_layers, block_size, kv_heads,
        head_dim]`` payloads.  Returns True when stored; False (counted
        ``demotions_dropped``) when the arena cannot make room."""
        path = tuple(path)
        self._clock += 1
        old = self._prefix.get(path)
        if old is not None:
            # re-demotion of a path already held: refresh in place
            self._write_block(old.hb, kd, vd, ksd, vsd)
            old.last_used = self._clock
            self.demotions += 1
            return True
        hb = self._alloc()
        if hb is None:
            self.demotions_dropped += 1
            return False
        self._write_block(hb, kd, vd, ksd, vsd)
        self._prefix[path] = _PrefixEntry(hb, path, self._clock)
        self.demotions += 1
        return True

    def match_prefix(self, tokens, start_block):
        """The longest run of consecutive demoted FULL blocks extending a
        device-side radix match: block indices ``start_block,
        start_block+1, ...`` of ``tokens`` whose full token paths are
        all held here.  A pure lookup, NOT a reservation: callers that
        do work between match and pop must :meth:`pin_prefix` the
        result for that window.  A block covering tokens up to exactly
        ``len(tokens)`` is still promotable (the radix store's match
        caps keep one token to prefill)."""
        bs = self.block_size
        out = []
        i = int(start_block)
        while (i + 1) * bs <= len(tokens):
            path = tuple(tokens[:(i + 1) * bs])
            if path not in self._prefix:
                break
            out.append(path)
            i += 1
        return out

    def pin_prefix(self, paths):
        """Shield matched entries from arena-level LRU eviction for the
        match->pop window of a swap-in.  Pins nest; paths already gone
        are ignored.  Pair every call with :meth:`unpin_prefix`."""
        for p in paths:
            entry = self._prefix.get(tuple(p))
            if entry is not None:
                entry.pinned += 1

    def unpin_prefix(self, paths):
        """Release a :meth:`pin_prefix` hold (safe on paths since
        consumed by ``pop_prefix``)."""
        for p in paths:
            entry = self._prefix.get(tuple(p))
            if entry is not None and entry.pinned > 0:
                entry.pinned -= 1

    def pop_prefix(self, path):
        """Consume one matched entry for promotion: removes it from the
        index and returns its host block id, or None when the entry is
        gone.  The caller reads the payload, uploads it, then
        ``release``s the block."""
        entry = self._prefix.pop(tuple(path), None)
        if entry is None:
            return None
        self._clock += 1
        self.promotions += 1
        return entry.hb

    # ------------------------------------------------------ lane images
    def save_lane(self, request_id, n_tokens, blocks):
        """Store a preempted lane's full chain: ``blocks`` is a list of
        ``(kd, vd, ksd, vsd)`` per-block payloads in chain order,
        covering ``n_tokens`` positions.  All-or-nothing: if the arena
        cannot hold the whole chain even after evicting every prefix
        entry, nothing is kept and False is returned.  A previous
        unconsumed image of the same request is replaced."""
        self.drop_lane(request_id)
        hbs = []
        for kd, vd, ksd, vsd in blocks:
            hb = self._alloc()
            if hb is None:
                for h in hbs:
                    self.release(h)
                return False
            self._write_block(hb, kd, vd, ksd, vsd)
            hbs.append(hb)
        self._lanes[request_id] = _LaneImage(hbs, n_tokens)
        self.lane_saves += 1
        return True

    def peek_lane(self, request_id):
        """The saved image of a request, or None (non-consuming)."""
        return self._lanes.get(request_id)

    def take_lane(self, request_id):
        """Consume a lane image for swap-in: removes it from the index
        and returns it.  The caller uploads the blocks it needs and
        ``release``s every host block of the image (used or not)."""
        img = self._lanes.pop(request_id, None)
        if img is not None:
            self.lane_restores += 1
        return img

    def drop_lane(self, request_id):
        """Invalidate an unconsumed image (abort, retire, re-save): its
        blocks return to the free list.  Idempotent."""
        img = self._lanes.pop(request_id, None)
        if img is None:
            return False
        for hb in img.hbs:
            self.release(hb)
        self.lane_drops += 1
        return True

    # ------------------------------------------------------------ admin
    def clear_prefixes(self):
        """Drop every demoted prefix entry (drain: cache content is
        disposable; anything still held afterwards is a leaked lane
        image).  Returns how many entries were dropped."""
        n = len(self._prefix)
        for entry in list(self._prefix.values()):
            del self._prefix[entry.path]
            self.release(entry.hb)
        return n

    def clear(self):
        """Drop everything — prefix entries AND lane images."""
        self.clear_prefixes()
        for rid in list(self._lanes):
            self.drop_lane(rid)

    # ------------------------------------------------------------ stats
    def stats(self):
        """The JAX tier's keys, plus ``pinned`` and ``host_syncs``."""
        return {
            "capacity_blocks": self.capacity,
            "free_blocks": self.free_blocks,
            "blocks_in_use": self.blocks_in_use,
            "bytes_in_use": self.bytes_in_use,
            "budget_bytes": self.budget_bytes,
            "bytes_per_block": self.bytes_per_block,
            "occupancy": self.occupancy,
            "prefix_entries": len(self._prefix),
            "lane_images": len(self._lanes),
            "demotions": self.demotions,
            "demotions_dropped": self.demotions_dropped,
            "promotions": self.promotions,
            "lane_saves": self.lane_saves,
            "lane_restores": self.lane_restores,
            "lane_drops": self.lane_drops,
            "prefix_evictions": self.prefix_evictions,
            "store_dtype": str(self.store_dtype).replace("torch.", ""),
            "quantized": self.quantized,
            "pinned": self.is_pinned(),
            "host_syncs": self.host_syncs,
        }
