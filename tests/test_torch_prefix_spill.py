"""The port's radix store's host-tier hooks against the JAX store's:
the ``spill``/``spill_batch`` demotion hooks (called with each evicted
full block's token path and still-live block, one batched call a
reclaim pass, before the block is released) and ``graft`` (a promoted
block hung back onto the tree), on the same scripted sequences.  Every
hook call, graft result, free list and ``stats()`` must be equal."""

import numpy as np
import pytest
import torch

from paddle_tpu.serving.kv_cache import PagedKVPool as JPool
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu_torch.serving.kv_cache import PagedKVPool
from paddle_tpu_torch.serving.prefix_cache import PrefixCache

from _torch_port_util import one_thread  # noqa: F401

BS = 4


def _store(port, capacity, num_blocks=64):
    if port:
        pool = PagedKVPool(num_layers=1, num_blocks=num_blocks,
                           block_size=BS, kv_heads=1, head_dim=2,
                           device="cpu")
        cache = PrefixCache(num_layers=1, block_size=BS, kv_heads=1,
                            head_dim=2, dtype=torch.float32,
                            budget_bytes=capacity * pool.bytes_per_block,
                            pool=pool)
    else:
        pool = JPool(num_layers=1, num_blocks=num_blocks, block_size=BS,
                     kv_heads=1, head_dim=2)
        cache = JPrefixCache(num_layers=1, block_size=BS, kv_heads=1,
                             head_dim=2,
                             budget_bytes=capacity * pool.bytes_per_block,
                             pool=pool,
                             bytes_per_block=pool.bytes_per_block)
    return pool, cache


def _hooks(cache, log, batched):
    """Install recording hooks that keep every other block (a demotion)
    and refuse the rest (a drop); each records the pool refcount of its
    blocks, which must still be held."""
    pool = cache.pool
    seen = [0]

    def spill(path, block):
        log.append(("spill", tuple(path), int(block),
                    int(pool.refcount(block))))
        seen[0] += 1
        return seen[0] % 2 == 0

    def spill_batch(paths, blocks):
        log.append(("spill_batch", [tuple(p) for p in paths],
                    [int(b) for b in blocks],
                    [int(pool.refcount(b)) for b in blocks]))
        out = []
        for _ in blocks:
            seen[0] += 1
            out.append(seen[0] % 2 == 0)
        return out

    cache.spill = spill
    if batched:
        cache.spill_batch = spill_batch


def _script(seed, n_ops=50):
    r = np.random.RandomState(seed)
    stems = [r.randint(0, 4, 12).tolist() for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        u = r.rand()
        stem = stems[r.randint(3)]
        if u < 0.55:
            cut = r.randint(1, len(stem) + 1)
            ops.append(("admit", stem[:cut] + r.randint(
                0, 4, r.randint(0, 6)).tolist()))
        elif u < 0.8:
            ops.append(("reclaim", int(r.randint(1, 5))))
        else:
            ops.append(("graft", stem + r.randint(0, 4, 3).tolist(),
                        int(r.randint(0, 4))))
    return ops


def _drive(store, ops, batched):
    pool, cache = store
    log = []
    _hooks(cache, log, batched)
    for op in ops:
        if op[0] == "admit":
            toks = op[1]
            lease = cache.acquire(toks)
            row = list(lease.block_ids)
            for bid in row:
                pool.share(bid)
            while len(row) < -(-len(toks) // BS):
                bid = pool.alloc()
                if bid is None:
                    assert cache.reclaim(1) == 1
                    continue
                row.append(bid)
            adopted = cache.adopt(toks, lease, block_of=lambda j: row[j])
            cache.release(lease)
            for bid in row:
                pool.release(bid)
            log.append(("admit", lease.matched_tokens, adopted))
        elif op[0] == "reclaim":
            log.append(("reclaim", cache.reclaim(op[1]), list(pool._free)))
        else:
            _, toks, index = op
            bid = pool.alloc()
            ok = cache.graft(toks, index, bid)
            if not ok:
                pool.release(bid)
            log.append(("graft", ok, cache.lookup(toks), list(pool._free)))
    log.append(("evicted_all", cache.reclaim(10 ** 6), pool.blocks_in_use))
    log.append(("stats", cache.stats()))
    return log


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "single"])
@pytest.mark.parametrize("capacity", [4, 12])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spill_and_graft_match_jax(seed, capacity, batched):
    """Equal logs, but for one repair: a graft whose own reclaim evicted
    its parent is refused by the port, where the JAX store hangs the
    block under the detached parent and leaks it (its final sweep
    leaves the block in use).  From such a graft on the logs part."""
    ops = _script(seed)
    ref = _drive(_store(False, capacity), ops, batched)
    out = _drive(_store(True, capacity), ops, batched)
    cut = next((i for i, (a, b) in enumerate(zip(ref, out)) if a != b),
               None)
    if cut is not None:
        assert ref[cut][:2] == ("graft", True), ref[cut]
        assert out[cut][:2] == ("graft", False), out[cut]
        assert ref[-2][2] > 0 and out[-2][2] == 0
        ref, out = ref[:cut], out[:cut]
    assert out == ref
    kinds = {e[0] for e in ref}
    assert ("spill_batch" if batched else "spill") in kinds
    assert any(e[0] == "graft" and e[1] for e in ref)
    # every hook ran while the store still held its block
    for e in ref:
        if e[0] == "spill":
            assert e[3] >= 1
        elif e[0] == "spill_batch":
            assert all(n >= 1 for n in e[3])
    full = _drive(_store(True, capacity), ops, batched)
    assert full[-2][2] == 0                  # the port never leaks
    st = full[-1][1]
    assert st["evictions"] == st["evictions_demoted"] + \
        st["evictions_dropped"]
    assert st["evictions_demoted"] > 0 and st["evictions_dropped"] > 0


def test_graft_refuses_missing_parent_and_zero_capacity():
    for port in (False, True):
        pool, cache = _store(port, 4)
        toks = list(range(12))
        bid = pool.alloc()
        assert not cache.graft(toks, 1, bid)     # parent block 0 missing
        assert cache.graft(toks, 0, bid)         # ownership transfers
        assert cache.lookup(toks) == 4
        assert cache.graft(toks, 1, pool.alloc())
        assert cache.lookup(toks) == 8
        assert cache.reclaim(10) == 2 and pool.blocks_in_use == 0
        pool, empty = _store(port, 0)
        assert not empty.graft(toks, 0, pool.alloc())


def test_graft_under_a_parent_its_reclaim_evicted_is_refused():
    """A full store whose one evictable leaf is the graft's own parent:
    the port refuses the graft and leaks nothing; the JAX store grafts
    under the detached parent and its final sweep leaves a block."""
    ends = {}
    for port in (False, True):
        pool, cache = _store(port, 1)
        toks = list(range(8))
        assert cache.graft(toks, 0, pool.alloc())   # the store is full
        bid = pool.alloc()
        ok = cache.graft(toks, 1, bid)
        if not ok:
            pool.release(bid)
        cache.reclaim(10)
        ends[port] = (ok, pool.blocks_in_use)
    assert ends == {False: (True, 1), True: (False, 0)}
