"""Shared-prefix KV reuse: a block-granular radix store over prompt
token ids, holding refcounted blocks of the engine's paged KV pool
(counterpart of ``paddle_tpu/serving/prefix_cache.py`` in its
unified-pool mode, the only mode the JAX engine uses).

* **Radix store** — a trie whose edges are full blocks of
  ``block_size`` token ids: shared prefixes share nodes.  Matching walks
  full blocks only and is capped at ``len(prompt) - 1`` tokens, so an
  exact-hit prompt still prefills its final token (the logits source of
  its first sampled token).
* **Copy-free hits** — the store holds blocks of the SAME pool the slot
  block tables point into.  The engine leases matched blocks straight
  into a slot's table (``PagedKVCache.lease_block``), and serves a
  partial tail match copy-on-write: it copies ``lease.tail_block`` into
  the slot's first private block before the prefill, which then
  overwrites it from offset ``lease.tail_tokens`` on.
* **Adoption** — caching new content is :meth:`PrefixCache.adopt`: the
  store takes a shared reference on each full block a prefill just
  wrote.  Nothing is copied.
* **LRU eviction under a byte budget** — the store holds at most
  ``budget_bytes // bytes_per_block`` blocks; :meth:`reclaim` evicts
  the least-recently-used unpinned leaves back to the pool's free list
  (leaves only, so every cached chain stays reachable from the root).
  ``acquire()`` pins the matched chain while a slot borrows it and
  ``release()`` unpins it on retirement or preemption.

* **Demotion hooks** (the host KV tier): ``spill``/``spill_batch``
  are called with each evicted full block's token path and pool block
  BEFORE the block is released, so its bytes can be copied into the
  host arena; a reclaim pass makes ONE batched ``spill_batch`` call.
  :meth:`graft` hangs a block swapped back in from the arena onto the
  tree.

Everything here is host bookkeeping over small Python dicts; the only
device state is the pool.  Not ported: the standalone-buffer mode
(``pool=None``: ``insert`` into buffers of the store's own).
"""

from __future__ import annotations

from ..observability import metrics as _obs_metrics

_SRV_PREFIX_EVICT = _obs_metrics.counter(
    "serving.prefix_evictions",
    "radix-store evictions by destination: dest=\"host\" demoted into "
    "the host spill arena, dest=\"dropped\" lost and recomputable only")


class _Node:
    """One full-block edge of the radix store."""

    __slots__ = ("tokens", "block", "parent", "children", "refcount",
                 "last_used")

    def __init__(self, tokens, block, parent):
        self.tokens = tokens          # tuple of block_size token ids
        self.block = block            # pool block id (>= 1; 0 is scratch)
        self.parent = parent
        self.children = {}            # block-token tuple -> _Node
        self.refcount = 0
        self.last_used = 0


class PrefixLease:
    """A pinned match: the node chain a running request borrows.

    ``block_ids`` are the pool blocks covering the full-block part of
    the match (``len(block_ids) * block_size`` tokens).  A partial tail
    match rides along: ``tail_block`` is a cached block whose first
    ``tail_tokens`` tokens extend the full-block match
    (``matched_tokens`` includes them), served copy-on-write.  The tail
    node is pinned in ``nodes`` but its block is NOT in ``block_ids``:
    it is never leased into a table directly.  :meth:`PrefixCache.adopt`
    pins the nodes it creates into the lease too."""

    __slots__ = ("nodes", "block_ids", "matched_tokens", "tail_block",
                 "tail_tokens")

    def __init__(self, nodes, block_size):
        self.nodes = list(nodes)
        self.block_ids = [n.block for n in self.nodes]
        self.matched_tokens = len(self.nodes) * block_size
        self.tail_block = None
        self.tail_tokens = 0


class PrefixCache:
    """The radix store over a :class:`~.kv_cache.PagedKVPool`.

    ``budget_bytes`` bounds how many pool blocks the store may hold
    (``budget_bytes // bytes_per_block``); a budget below one block (or
    ``block_size=0``) gives capacity 0, and then every lookup misses.
    ``bytes_per_block`` defaults to the pool's own."""

    def __init__(self, num_layers, block_size, kv_heads, head_dim,
                 dtype=None, budget_bytes=0, pool=None,
                 bytes_per_block=None):
        if pool is None:
            raise ValueError(
                "PrefixCache needs the engine's PagedKVPool (pool=...); "
                "the standalone-buffer mode is not ported")
        self.num_layers = num_layers
        self.block_size = int(block_size)
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.bytes_per_block = bytes_per_block or pool.bytes_per_block
        self.capacity = max(0, int(budget_bytes) // self.bytes_per_block) \
            if self.block_size else 0
        self.pool = pool
        self._held = 0               # pool blocks the radix store holds
        self._root = _Node((), 0, None)
        self._clock = 0
        #: demotion hook (host KV tier): ``spill(path_tokens, block_id)
        #: -> bool`` is called with an evicted block's FULL token path
        #: and its still-live pool block BEFORE the block is released; a
        #: True return means its bytes now live in the host arena
        #: (dest="host"), False/None that the eviction is a drop.  None
        #: keeps drop-on-evict.
        self.spill = None
        #: batched demotion hook: ``spill_batch(paths, block_ids) ->
        #: [bool, ...]``, the same contract over a whole eviction pass,
        #: so a bulk ``reclaim()`` copies all its victims in one call.
        #: Preferred over ``spill`` wherever it is installed.
        self.spill_batch = None
        #: label of the eviction counter (the engine's profiler name)
        self.metric_label = ""
        # counters (the engine surfaces them through stats())
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0
        self.evictions_demoted = 0
        self.evictions_dropped = 0
        self.inserted_blocks = 0

    # ------------------------------------------------------------ match
    def _walk(self, tokens, limit_tokens):
        """The matched node chain for ``tokens``, full blocks only,
        covering at most ``limit_tokens`` tokens."""
        bs = self.block_size
        chain = []
        if not bs or self.capacity == 0:
            return chain
        node = self._root
        for i in range(limit_tokens // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            chain.append(child)
            node = child
        return chain

    def _cow_match(self, tokens, chain):
        """The partial-tail match after the full-block walk: among the
        children of the last matched node, the one sharing the longest
        common token prefix with the rest of ``tokens``.  Returns
        ``(node, m)`` with ``0 < m < block_size`` tokens usable
        copy-on-write, or ``(None, 0)``.  The cap at
        ``len(tokens) - 1 - matched`` keeps one token to prefill, and
        also proves ``m < block_size``: a child matching a WHOLE in-cap
        block would have been matched by the walk."""
        matched = len(chain) * self.block_size
        node = chain[-1] if chain else self._root
        rest = tokens[matched:]
        cap = len(tokens) - 1 - matched
        best, best_m = None, 0
        for child in node.children.values():
            m = 0
            for a, b in zip(child.tokens, rest):
                if a != b:
                    break
                m += 1
            m = min(m, cap)
            if m > best_m:
                best, best_m = child, m
        return best, best_m

    def lookup(self, tokens):
        """Matched-prefix length in tokens, side-effect free (admission
        sizing), including the copy-on-write tail match; capped at
        ``len(tokens) - 1``."""
        chain = self._walk(tokens, len(tokens) - 1)
        _, m = self._cow_match(tokens, chain)
        return len(chain) * self.block_size + m

    def acquire(self, tokens):
        """Match + pin: refcount the matched chain (and a partial tail
        match, exposed as ``lease.tail_block``/``tail_tokens``) and bump
        its LRU clock.  Returns the lease the engine holds until the
        request retires or is preempted."""
        chain = self._walk(tokens, len(tokens) - 1)
        self._clock += 1
        for n in chain:
            n.refcount += 1
            n.last_used = self._clock
        lease = PrefixLease(chain, self.block_size)
        tail, m = self._cow_match(tokens, chain)
        if m > 0:
            tail.refcount += 1
            tail.last_used = self._clock
            lease.nodes.append(tail)
            lease.tail_block = tail.block
            lease.tail_tokens = m
            lease.matched_tokens += m
        self.hit_tokens += lease.matched_tokens
        self.miss_tokens += len(tokens) - lease.matched_tokens
        return lease

    def release(self, lease):
        """Unpin a lease (idempotent): the chain becomes evictable once
        no other slot borrows it."""
        for n in lease.nodes:
            if n.refcount > 0:
                n.refcount -= 1
        lease.nodes = []

    # ------------------------------------------------------------ cache
    def adopt(self, tokens, lease, block_of):
        """Take shared references on a slot's freshly written private
        blocks.  Called after a prefill dispatch: ``block_of(i)`` maps
        full-block index ``i`` of ``tokens`` to the pool block the
        slot's table points at.  Blocks already cached are skipped;
        each missing one gets a new node holding ``pool.share(block)``
        (a COW tail copy, complete after the prefill, lands as a sibling
        of its source), pinned into ``lease``.  Stops when the budget is
        spent and nothing is evictable, or at a scratch entry.  Returns
        the number of blocks adopted."""
        bs = self.block_size
        if not bs or self.capacity == 0:
            return 0
        self._clock += 1
        node = self._root
        adopted = 0
        for i in range(len(tokens) // bs):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                if self._held >= self.capacity and self.reclaim(1) == 0:
                    break
                block = int(block_of(i))
                if block == 0:
                    break            # scratch: the slot row ended early
                self.pool.share(block)
                self._held += 1
                child = _Node(key, block, node)
                node.children[key] = child
                child.refcount += 1
                lease.nodes.append(child)
                adopted += 1
                self.inserted_blocks += 1
            child.last_used = self._clock
            node = child
        return adopted

    def graft(self, tokens, index, block):
        """Promotion from the host tier: hang an engine-allocated pool
        block, freshly uploaded from the arena, onto the tree at
        full-block ``index`` of ``tokens``.  Ownership of the block's
        reference TRANSFERS to the new node (the caller ``pool.alloc``ed
        it and must not release it on success).  The node's key is
        ``tokens[index*bs : (index+1)*bs]``, shorter than a block for a
        partial tail, which only ever matches copy-on-write.  Returns
        False (the caller keeps ownership) when the parent chain is
        missing (promotions land in path order) or when the budget is
        spent and nothing is evictable."""
        bs = self.block_size
        if not bs or self.capacity == 0:
            return False
        node = self._root
        for i in range(index):
            node = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if node is None:
                return False
        key = tuple(tokens[index * bs:(index + 1) * bs])
        if not key or key in node.children:
            return False
        if self._held >= self.capacity:
            if self.reclaim(1) == 0:
                return False
            # the reclaim may have evicted the parent itself (an
            # unpinned leaf, e.g. the block grafted just before): a
            # child hung under a detached node could never be evicted
            # and would leak its block, so the graft is refused
            if not self._attached(node):
                return False
        self._clock += 1
        self._held += 1
        child = _Node(key, int(block), node)
        node.children[key] = child
        child.last_used = self._clock
        self.inserted_blocks += 1
        return True

    def _attached(self, node):
        """True while ``node`` is reachable from the root."""
        while node is not self._root:
            parent = node.parent
            if parent.children.get(node.tokens) is not node:
                return False
            node = parent
        return True

    def reclaim(self, n_blocks):
        """Evict up to ``n_blocks`` LRU unpinned leaves, returning their
        blocks to the pool's free list.  Returns how many were freed (0
        when everything held is pinned).  Victims are detached first and
        demoted in ONE batched spill pass, then released."""
        victims = []
        while len(victims) < n_blocks:
            victim = self._lru_evictable()
            if victim is None:
                break
            # detach now (so the parent can become the next leaf) but
            # defer spill and release: the blocks' bytes must stay live
            # for the batched copy below
            del victim.parent.children[victim.tokens]
            victims.append(victim)
        for node, demoted in zip(victims, self._spill_nodes(victims)):
            self._release_evicted(node, demoted)
        return len(victims)

    def _lru_evictable(self):
        """Oldest unpinned leaf, or None.  Leaves only: interior nodes
        stay until their whole subtree ages out."""
        best = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.children or node.refcount:
                continue
            if best is None or node.last_used < best.last_used:
                best = node
        return best

    def _node_path(self, node):
        """The full token path from the root through ``node``: the key a
        demoted block re-matches under."""
        parts = []
        while node is not self._root:
            parts.append(node.tokens)
            node = node.parent
        out = ()
        for tokens in reversed(parts):
            out += tokens
        return out

    def _evict(self, node):
        """Detach a leaf, offer it to the spill hook, and drop the
        store's reference on its block."""
        del node.parent.children[node.tokens]
        self._release_evicted(node, self._spill_nodes([node])[0])

    def _spill_nodes(self, nodes):
        """Demote-instead-of-drop for a pass of detached victims: one
        bool per node, True when its bytes now live in the host tier.
        Runs BEFORE the victims' pool blocks are released.  Full-block
        victims go through ``spill_batch`` when installed (one call for
        the pass), else per-node ``spill``; partial-tail graft nodes
        (a key shorter than a block) are dropped."""
        out = [False] * len(nodes)
        if self.spill is None and self.spill_batch is None:
            return out
        full = [i for i, n in enumerate(nodes)
                if len(n.tokens) == self.block_size]
        if not full:
            return out
        if self.spill_batch is not None:
            kept = self.spill_batch(
                [self._node_path(nodes[i]) for i in full],
                [nodes[i].block for i in full])
            for i, ok in zip(full, kept):
                out[i] = bool(ok)
        else:
            for i in full:
                out[i] = bool(self.spill(self._node_path(nodes[i]),
                                         nodes[i].block))
        return out

    def _release_evicted(self, node, demoted):
        """Return a detached victim's block to the pool and settle the
        eviction counters."""
        self.pool.release(node.block)
        self._held -= 1
        self.evictions += 1
        if demoted:
            self.evictions_demoted += 1
        else:
            self.evictions_dropped += 1
        _SRV_PREFIX_EVICT.inc(engine=self.metric_label,
                              dest="host" if demoted else "dropped")

    # ------------------------------------------------------------ stats
    def _count_nodes(self):
        n, stack = 0, [self._root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def stats(self):
        """The JAX store's keys."""
        total = self.hit_tokens + self.miss_tokens
        return {
            "block_size": self.block_size,
            "capacity_blocks": self.capacity,
            "used_blocks": self._held,
            "cached_nodes": self._count_nodes(),
            "hit_tokens": self.hit_tokens,
            "miss_tokens": self.miss_tokens,
            "hit_ratio": (self.hit_tokens / total) if total else 0.0,
            "evictions": self.evictions,
            "evictions_demoted": self.evictions_demoted,
            "evictions_dropped": self.evictions_dropped,
            "inserted_blocks": self.inserted_blocks,
        }
