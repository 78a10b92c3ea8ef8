"""The port's paged KV pool against the JAX package's: ``paged_write``
and its scatter coordinates must match exactly (they move values, no
arithmetic), and the pool / cache bookkeeping must make the same block
decisions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.serving.kv_cache import (
    PagedKVCache as JPagedKVCache, PagedKVPool as JPagedKVPool,
    _write_coords as j_write_coords, paged_write as j_paged_write,
)
from paddle_tpu_torch.serving.kv_cache import (
    PagedKVCache, PagedKVPool, _write_coords, paged_write,
)

from _torch_port_util import one_thread  # noqa: F401


def _write_case(s, seed=0):
    """Two lanes writing ``s`` tokens; lane 1's window runs past its
    table's coverage (those tokens go to scratch), lane 2 is padding."""
    r = np.random.RandomState(seed)
    bs, nb, h, d = 4, 3, 2, 8
    pool = r.randn(1 + 3 * nb, bs, h, d).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    pos = np.array([2, 6, 0], np.int32)
    new = r.randn(3, s, h, d).astype(np.float32)
    return pool, new, tables, pos


@pytest.mark.parametrize("s", [1, 4, 7])
def test_write_coords_match(s):
    _, _, tables, pos = _write_case(s)
    jb, jo = j_write_coords(4, s, jnp.asarray(tables), jnp.asarray(pos))
    tb, to = _write_coords(4, s, torch.from_numpy(tables),
                           torch.from_numpy(pos))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("s", [1, 4, 7])
def test_paged_write_matches_exactly_and_writes_in_place(s):
    pool, new, tables, pos = _write_case(s, seed=1)
    ref = np.asarray(j_paged_write(jnp.asarray(pool), jnp.asarray(new),
                                   jnp.asarray(tables), jnp.asarray(pos)))
    tp = torch.from_numpy(pool.copy())
    out = paged_write(tp, torch.from_numpy(new), torch.from_numpy(tables),
                      torch.from_numpy(pos))
    assert out is tp
    # block 0 is scratch: colliding writes land there in unspecified
    # order on both sides, so only the live blocks are compared
    np.testing.assert_array_equal(out.numpy()[1:], ref[1:])


def test_paged_write_casts_to_the_pool_dtype():
    pool, new, tables, pos = _write_case(2, seed=2)
    tp = torch.from_numpy(pool).to(torch.bfloat16)
    paged_write(tp, torch.from_numpy(new), torch.from_numpy(tables),
                torch.from_numpy(pos))
    assert tp.dtype == torch.bfloat16
    assert torch.equal(tp[1, 2], torch.from_numpy(new[0, 0]).bfloat16())


def test_pool_refcounts_and_pinned_scratch():
    pool = PagedKVPool(num_layers=2, num_blocks=4, block_size=4,
                       kv_heads=2, head_dim=8, device="cpu")
    assert (pool.capacity, pool.free_blocks, pool.blocks_in_use) == (3, 3, 0)
    assert pool.refcount(0) == 1
    a, b, c = pool.alloc(), pool.alloc(), pool.alloc()
    assert (a, b, c) == (1, 2, 3) and pool.alloc() is None
    pool.share(a)
    pool.release(a)
    assert pool.refcount(a) == 1 and pool.free_blocks == 0
    pool.release(a)
    assert pool.refcount(a) == 0 and pool.free_blocks == 1
    pool.release(0)                           # scratch is never released
    assert pool.refcount(0) == 1
    with pytest.raises(ValueError, match="over-released"):
        pool.release(a)
    with pytest.raises(ValueError, match="shared while free"):
        pool.share(a)
    assert pool.alloc() == a
    assert pool.k[0].shape == (4, 4, 2, 8) and len(pool.v) == 2
    assert pool.bytes_per_block == 2 * 2 * 4 * 2 * 8 * 4
    with pytest.raises(ValueError, match=">= 2 blocks"):
        PagedKVPool(1, 1, 4, 2, 8, device="cpu")


def test_pool_matches_jax_pool_on_a_random_op_sequence():
    r = np.random.RandomState(0)
    tp = PagedKVPool(1, 9, 4, 1, 8, device="cpu")
    jp = JPagedKVPool(1, 9, 4, 1, 8)
    live = []
    for _ in range(200):
        op = r.randint(3)
        if op == 0:
            a, b = tp.alloc(), jp.alloc()
            assert a == b
            if a is not None:
                live.append(a)
        elif live and op == 1:
            bid = live[r.randint(len(live))]
            tp.share(bid)
            jp.share(bid)
            live.append(bid)
        elif live:
            bid = live.pop(r.randint(len(live)))
            tp.release(bid)
            jp.release(bid)
        assert [tp.refcount(i) for i in range(9)] == \
            [jp.refcount(i) for i in range(9)]
        assert tp.free_blocks == jp.free_blocks


def test_cache_lazy_blocks_and_release_match_jax():
    kw = dict(num_layers=2, num_slots=3, max_seq_len=20, block_size=4,
              kv_heads=1, head_dim=8)
    tc, jc = PagedKVCache(**kw, device="cpu"), JPagedKVCache(**kw)
    assert tc.max_blocks_per_slot == jc.max_blocks_per_slot == 5
    assert tc.pool.num_blocks == jc.pool.num_blocks == 16
    for c in (tc, jc):
        s0, s1 = c.alloc(), c.alloc()
        assert (s0, s1) == (0, 1)
        assert c.ensure_blocks(s0, 6)
        assert c.ensure_blocks(s1, 3)
        assert c.ensure_blocks(s0, 9)          # only the new entry
        assert c.ensure_blocks(s1, 100)        # clamps to the row
    np.testing.assert_array_equal(tc.tables, jc.tables)
    assert tc.leased_blocks == 8 and tc.pool.blocks_in_use == 8
    tc.release_slot_blocks(1)
    assert not tc.tables[1].any() and tc.pool.blocks_in_use == 3
    assert tc.tables_dirty
    tc.release_slot_blocks(0)
    tc.free(0)
    tc.free(1)
    assert tc.pool.blocks_in_use == 0 and tc.free_slots == 3
    with pytest.raises(ValueError, match="double-freed"):
        tc.free(1)


def test_cache_ensure_blocks_reports_a_dry_pool():
    c = PagedKVCache(1, 2, 16, 4, 1, 8, num_blocks=3, device="cpu")
    assert c.ensure_blocks(0, 8)
    assert not c.ensure_blocks(1, 4)
    assert c.pool.free_blocks == 0


def test_layer_views_share_tables_and_pos():
    c = PagedKVCache(3, 2, 16, 4, 1, 8, device="cpu")
    tables = torch.zeros(2, 4, dtype=torch.int32)
    pos = torch.tensor([1, 2], dtype=torch.int32)
    views = c.layer_views(tables, pos)
    assert len(views) == 3
    assert all(v.tables is tables and v.pos is pos for v in views)
    assert views[1].k is c.pool.k[1] and views[0].block_size == 4
