"""The port's radix prefix store (``paddle_tpu_torch.serving.prefix_cache``)
against the JAX package's, in unified-pool mode, on the same scripted
sequences of ``lookup``/``acquire``/``adopt``/``release``/``reclaim``.

Both stores sit over a pool of their own package (the JAX one over a JAX
``PagedKVPool``), driven as the engines drive them: an admission
acquires a lease, leases its full-block hits into a table row (one pool
reference each), allocates private blocks for the rest, then adopts the
row; a retirement releases the lease and the row.  Every lookup, lease
(matched and tail tokens, block ids), adoption count, reclaim count,
the pools' free lists (the eviction order) and the final ``stats()``
must be equal.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.serving.kv_cache import PagedKVPool as JPool
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu_torch.serving.kv_cache import PagedKVPool
from paddle_tpu_torch.serving.prefix_cache import PrefixCache

from _torch_port_util import one_thread  # noqa: F401

BS = 4


def _jax_store(capacity, num_blocks):
    pool = JPool(num_layers=1, num_blocks=num_blocks, block_size=BS,
                 kv_heads=1, head_dim=2)
    return pool, JPrefixCache(
        num_layers=1, block_size=BS, kv_heads=1, head_dim=2,
        budget_bytes=capacity * pool.bytes_per_block, pool=pool,
        bytes_per_block=pool.bytes_per_block)


def _port_store(capacity, num_blocks):
    pool = PagedKVPool(num_layers=1, num_blocks=num_blocks, block_size=BS,
                       kv_heads=1, head_dim=2, device="cpu")
    return pool, PrefixCache(
        num_layers=1, block_size=BS, kv_heads=1, head_dim=2,
        dtype=torch.float32, budget_bytes=capacity * pool.bytes_per_block,
        pool=pool, bytes_per_block=pool.bytes_per_block)


def _script(seed, n_ops=60):
    """Admissions of prompts grown from three shared stems over a
    4-token vocabulary (so full-block hits, partial tail matches and
    misses all occur), retirements, reclaims and lookups."""
    r = np.random.RandomState(seed)
    stems = [r.randint(0, 4, 10).tolist() for _ in range(3)]
    ops, live = [], 0
    for _ in range(n_ops):
        u = r.rand()
        if u < 0.5 or live == 0:
            stem = stems[r.randint(3)]
            cut = r.randint(1, len(stem) + 1)
            toks = stem[:cut] + r.randint(0, 4, r.randint(0, 7)).tolist()
            ops.append(("admit", toks))
            live += 1
        elif u < 0.75:
            ops.append(("retire", int(r.randint(live))))
            live -= 1
        elif u < 0.9:
            ops.append(("reclaim", int(r.randint(1, 4))))
        else:
            stem = stems[r.randint(3)]
            ops.append(("lookup", stem + r.randint(0, 4, 3).tolist()))
    return ops


def _drive(store, ops):
    pool, cache = store
    log, live = [], []                       # live: (lease, table row)
    for kind, arg in ops:
        if kind == "admit":
            toks = arg
            lease = cache.acquire(toks)
            row = list(lease.block_ids)
            for bid in row:
                pool.share(bid)              # the table entry's reference
            cover = -(-len(toks) // BS)
            while len(row) < cover:
                bid = pool.alloc()
                if bid is None:
                    assert cache.reclaim(1) == 1, "script ran the pool dry"
                    continue
                row.append(bid)
            adopted = cache.adopt(toks, lease, block_of=lambda j: row[j])
            log.append(("admit", lease.matched_tokens, lease.tail_tokens,
                        lease.tail_block, list(lease.block_ids), adopted))
            live.append((lease, row))
        elif kind == "retire":
            lease, row = live.pop(arg)
            cache.release(lease)
            for bid in row:
                pool.release(bid)
            log.append(("retire", pool.blocks_in_use))
        elif kind == "reclaim":
            log.append(("reclaim", cache.reclaim(arg), list(pool._free)))
        else:
            log.append(("lookup", cache.lookup(arg)))
    while live:
        lease, row = live.pop()
        cache.release(lease)
        for bid in row:
            pool.release(bid)
    log.append(("drained", pool.blocks_in_use, list(pool._free)))
    log.append(("evicted_all", cache.reclaim(10 ** 6), pool.blocks_in_use))
    log.append(("stats", cache.stats()))
    return log


@pytest.mark.parametrize("capacity", [3, 6, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_sequence_matches_jax(seed, capacity):
    ops = _script(seed)
    ref = _drive(_jax_store(capacity, 64), ops)
    out = _drive(_port_store(capacity, 64), ops)
    assert out == ref
    kinds = [e[0] for e in ref]
    assert "reclaim" in kinds and "lookup" in kinds
    if capacity == 40:
        # the script reaches every kind of match
        admits = [e for e in ref if e[0] == "admit"]
        assert any(e[1] and not e[2] for e in admits)     # full blocks only
        assert any(e[2] for e in admits)                  # COW tail
        assert any(e[1] == 0 for e in admits)             # miss


def test_match_is_block_granular_with_a_cow_tail():
    """The JAX unit examples in unified mode: ``lookup`` caps at
    ``len - 1`` and adds the copy-on-write tail of the best sibling."""
    for pool, cache in (_jax_store(4, 16), _port_store(4, 16)):
        p = [7, 3, 9, 1, 4, 4, 2, 8, 5]          # 9 tokens: 2 full blocks
        lease = cache.acquire(p)
        assert lease.matched_tokens == 0
        row = [pool.alloc() for _ in range(3)]
        assert cache.adopt(p, lease, block_of=lambda j: row[j]) == 2
        cache.release(lease)
        assert cache.lookup(p + [1]) == 8
        assert cache.lookup(p) == 8              # cap len-1 = 8
        assert cache.lookup(p[:8]) == 7          # 4 + a 3-token tail
        assert cache.lookup([7, 3, 9, 1, 4, 4, 0, 0, 0]) == 6
        assert cache.lookup([1] + p) == 0
        tail = cache.acquire([7, 3, 9, 1, 4, 4, 0, 0, 0])
        assert (tail.block_ids, tail.tail_block, tail.tail_tokens) == \
            ([row[0]], row[1], 2)
        cache.release(tail)


def test_pinned_chains_survive_reclaim_and_leaves_go_first():
    for pool, cache in (_jax_store(8, 16), _port_store(8, 16)):
        a, b = [1] * 8 + [0], [2] * 8 + [0]
        la = cache.acquire(a)
        ra = [pool.alloc() for _ in range(3)]
        cache.adopt(a, la, block_of=lambda j: ra[j])
        lb = cache.acquire(b)
        rb = [pool.alloc() for _ in range(3)]
        cache.adopt(b, lb, block_of=lambda j: rb[j])
        for bid in ra + rb:
            pool.release(bid)                    # the rows retire
        cache.release(lb)                        # a stays pinned
        assert cache.reclaim(1) == 1             # b's leaf first...
        assert cache.lookup(b) == 4
        assert cache.reclaim(5) == 1             # ...then its root: a pinned
        assert cache.lookup(a) == 8
        cache.release(la)
        assert cache.reclaim(5) == 2
        assert pool.blocks_in_use == 0
        assert cache.stats()["evictions"] == 4


def test_zero_capacity_always_misses():
    pool, cache = _port_store(0, 8)
    lease = cache.acquire([1, 2, 3, 4, 5])
    assert lease.matched_tokens == 0
    assert cache.adopt([1, 2, 3, 4, 5], lease, block_of=lambda j: 1) == 0
    assert cache.stats()["capacity_blocks"] == 0
    assert pool.blocks_in_use == 0


def test_standalone_mode_is_not_ported():
    with pytest.raises(ValueError, match="pool"):
        PrefixCache(num_layers=1, block_size=BS, kv_heads=1, head_dim=2,
                    budget_bytes=1 << 20)
