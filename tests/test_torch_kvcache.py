"""The port's unified KV pool against the JAX package's, on the CPU.

One scripted sequence of alloc / append / free / grow / shrink / quota
moves, prefix sharing (``share_prefix``, copy-on-write appends) and
prefix-index moves (``insert``, ``reclaim``, ``release_from`` through a
shrink) is replayed on both packages; after every step the allocator's
free list, refcounts and usage, the views' quotas, tables and shared
prefixes, the index entries and counters, and the arena size must be
exactly equal.  The refcounted allocator's battery of
``tests/test_kvcache.py`` (sharing and double free, fragmentation
against the shrinkable tail, the random sharing interleaving) runs on
both packages' allocators and pools with the same op script.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro import config as jconfig
from repro import configs as jconfigs
from repro.serving import kvcache as J
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.config import BLOCK_TOKENS
from repro_torch.serving import kvcache as T

torch.set_num_threads(2)


def _state(pool):
    a = pool.allocator
    views = {n: (v.quota, v.used, {s: (list(c.bases), c.n_tokens, c.shared)
                                   for s, c in v.seqs.items()},
                 None if v.prefix_index is None
                 else (v.prefix_index.entries(), v.prefix_index.stats()))
             for n, v in pool.views.items()}
    return (a.free_ranges(), a.refcounts(), a.used, a.physical_used,
            a.n_blocks, a.shrinkable_tail(), a.largest_free_range(),
            round(a.fragmentation(), 12), pool.available_blocks(),
            pool.n_head_blocks, tuple(pool.k.shape), dict(pool.used_by),
            views, round(pool.utilization(), 12))


def _script(pool, config, configs):
    """The replayed script (with one package's config modules); returns
    the states it passes through and the block tables it reads."""
    cfg = configs.get_reduced("qwen2-7b")
    a = pool.register_model(config.replace(cfg, name="a"), 600)
    b = pool.register_model(config.replace(cfg, name="b"), 300)
    out = [_state(pool)]
    for sid, n in [(0, 40), (1, 17), (2, 64)]:
        assert a.append_tokens(sid, n)
        out.append(_state(pool))
    assert b.append_tokens(10, 33)
    assert not b.can_append(11, 16 * 80)           # past the quota
    assert not b.append_tokens(11, 16 * 80)
    out.append(_state(pool))
    a.free_seq(1)
    out.append(_state(pool))
    for _ in range(20):                             # one token at a time
        assert a.append_tokens(0, 1)
    out.append(_state(pool))
    assert pool.grow(64) == 64                      # a live arena grows
    out.append(_state(pool))
    assert b.append_tokens(12, 100)
    out.append(_state(pool))
    out.append(pool.shrink(200))                    # clamped by live tail
    out.append(_state(pool))
    pool.adapt_quotas(min_quota=16)
    assert pool.grant_min_quota(b, b.quota + 8)
    out.append(_state(pool))
    tables = (a.block_table([0, 2], 8), b.block_table([10, 12], 4),
              a.seq_lens([0, 2]))
    for sid in (0, 2):
        a.free_seq(sid)
    for sid in (10, 12):
        b.free_seq(sid)
    out.append(_state(pool))
    out.append(pool.shrink(64))                     # idle: exact inverse
    out.append(_state(pool))
    assert pool.grow(32) == 32                      # an idle arena reallocates
    out.append(_state(pool))
    fused = J.fused_block_tables if isinstance(pool, J.UnifiedKVPool) \
        else T.fused_block_tables
    assert a.append_tokens(20, 50) and b.append_tokens(21, 7)
    tables += fused([(a, [20]), (b, [21])], rows=4, max_blocks=6)
    out.append(_state(pool))
    # prefix sharing: the allocator's own share, then a view's
    alloc = pool.allocator
    g = a.group_size
    alloc.share(a.seqs[20].bases[0], g)
    out.append((alloc.refcount(a.seqs[20].bases[0]), _state(pool)))
    alloc.free(a.seqs[20].bases[0], g)
    assert a.share_prefix(30, a.seqs[20].bases[:2], 24)   # mid-block
    out.append(_state(pool))
    assert a.append_tokens(30, 3)                         # copy-on-write
    out.append(_state(pool))
    if a.prefix_index is None:
        return out, tables
    # the prefix index: insert, adopt, evict under pressure, release a
    # doomed tail through shrink, clear
    rng = np.random.default_rng(4)
    prompt = [int(t) for t in rng.integers(1, 500, 50)]
    out.append(a.prefix_index.insert(prompt, a.seqs[20].bases))
    out.append((a.prefix_index.lookup(prompt + [1]), _state(pool)))
    for sid in (20, 30):
        a.free_seq(sid)
    b.free_seq(21)
    out.append(_state(pool))
    for sid in range(40, 48):                   # index-only inventory
        p = [int(t) for t in rng.integers(1, 500, 16)]
        assert a.append_tokens(sid, 16)
        a.prefix_index.insert(p, a.seqs[sid].bases)
        a.free_seq(sid)
    out.append(_state(pool))
    out.append(a.prefix_index.reclaim(2 * g))
    out.append(_state(pool))
    out.append(pool.reclaim_index_blocks(alloc.free_blocks + 3 * g))
    out.append(_state(pool))
    out.append(pool.shrink(pool.n_head_blocks - 2 * g))   # release_from
    out.append(_state(pool))
    out.append(pool.grow(40))
    out.append(_state(pool))
    pool.unregister_model("a")                  # clears the index
    out.append(_state(pool))
    return out, tables


@pytest.mark.parametrize("cache", [False, True], ids=["plain", "prefix"])
def test_pool_script_replays_identically(cache):
    jpool = J.UnifiedKVPool(1200, 64, dtype=jnp.float32, prefix_cache=cache)
    tpool = T.UnifiedKVPool(1200, 64, dtype=torch.float32, device="cpu",
                            prefix_cache=cache)
    jstates, jtables = _script(jpool, jconfig, jconfigs)
    tstates, ttables = _script(tpool, tconfig, tconfigs)
    assert len(jstates) == len(tstates)
    for i, (js, ts) in enumerate(zip(jstates, tstates)):
        assert js == ts, f"state {i} differs"
    for jt, tt in zip(jtables, ttables):
        np.testing.assert_array_equal(jt, tt)
    assert tpool.k.dtype == torch.float32
    assert tpool.hbm_bytes() == jpool.hbm_bytes()
    assert tpool.head_block_bytes == jpool.head_block_bytes


def test_shrink_keeps_live_contents_and_grow_zeroes():
    pool = T.UnifiedKVPool(64, 8, dtype=torch.float32, device="cpu")
    cfg = tconfig.replace(tconfigs.get_reduced("qwen2-7b"), name="a",
                          head_dim=8)
    v = pool.register_model(cfg, 64)
    assert v.append_tokens(0, 16)                   # one 4-block group
    pool.k[:4] = 1.0
    assert pool.grow(8) == 8                        # live: contents kept
    assert torch.all(pool.k[:4] == 1.0) and torch.all(pool.k[64:] == 0)
    assert pool.shrink(8) == 8
    assert pool.k.shape[0] == 64 and torch.all(pool.k[:4] == 1.0)
    v.free_seq(0)
    assert pool.grow(4) == 4                        # idle: fresh zeros
    assert pool.k.shape[0] == 68 and torch.all(pool.k == 0)


def test_register_refuses_mismatched_head_dim():
    pool = T.UnifiedKVPool(16, 128, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="head_dim"):
        pool.register_model(tconfigs.get_reduced("qwen2-7b"), 8)


# ---------------------------------------------------------------------------
# the refcounted allocator's battery, on both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "port"])
def test_allocator_share_refcounts_and_double_free(pkg):
    a = pkg.BlockAllocator(16)
    s = a.alloc(4)
    a.share(s, 4)
    assert a.used == 8 and a.physical_used == 4
    assert a.refcount(s) == 2
    a.free(s, 4)                        # one holder lets go...
    assert a.used == 4 and a.physical_used == 4, \
        "a block must never be reclaimed while refcount > 0"
    assert a.alloc(16) is None, "shared blocks still occupy the arena"
    a.free(s, 4)                        # ...now the last one does
    assert a.used == 0 and a.free_blocks == 16
    with pytest.raises(ValueError):
        a.free(s, 4)                    # double free must raise
    with pytest.raises(ValueError):
        a.share(s, 1)                   # sharing free space is a bug
    assert a.alloc(16) == 0


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "port"])
def test_fragmentation_vs_shrinkable_tail(pkg):
    """``largest_free_range``/``fragmentation`` describe interior
    allocatability, not shrink capacity: a single pinned tail block
    clamps ``shrink`` however large the interior free space is."""
    a = pkg.BlockAllocator(64)
    s1 = a.alloc(48)
    s2 = a.alloc(16)                    # pins [48, 64): the tail
    a.free(s1, 48)                      # huge interior free run
    assert a.largest_free_range() == 48
    assert a.fragmentation() == 0.0
    assert a.shrinkable_tail() == 0, "pinned tail → nothing shrinkable"
    assert a.shrink(16) == 0, "shrink must refuse the pinned tail"
    assert a.n_blocks == 64
    a.free(s2, 16)
    assert a.shrinkable_tail() == 64


def _sharing_run(pool, cfg, ops):
    """``tests/test_kvcache.py::test_pool_sharing_interleaving``'s op
    script on one package's pool; checks its invariants after every op
    and returns the states it passes through."""
    base = pool.n_head_blocks
    view = pool.register_model(cfg, quota=10**9)
    gs = view.group_size
    granted = debt = 0
    live: list = []
    next_sid = 0
    states = []
    for kind, n in ops:
        if kind == 0:                      # new seq (may exhaust: ok=False)
            if view.append_tokens(next_sid, (n % 8 + 1) * BLOCK_TOKENS):
                live.append(next_sid)
            next_sid += 1
        elif kind == 1 and live:           # free a live seq
            view.free_seq(live.pop(n % len(live)))
        elif kind == 2 and granted == 0:   # build: settle debt, grow rest
            settle = min(debt, n)
            debt -= settle
            pool.grow(n - settle)
            granted = n
        elif kind == 3 and granted > 0:    # dissolve: shrink, book debt
            got = pool.shrink(granted)
            debt += granted - got
            granted = 0
        elif kind == 4 and live:           # adopt a donor's prefix
            donor = view.seqs[live[n % len(live)]]
            if donor.bases:
                k = 1 + n % len(donor.bases)
                tok = (k - 1) * BLOCK_TOKENS + 1 + n % BLOCK_TOKENS
                if view.share_prefix(next_sid, donor.bases[:k], tok):
                    live.append(next_sid)
                next_sid += 1
        elif kind == 5 and live:           # append (COW on shared tails)
            view.append_tokens(live[n % len(live)], n)
        alloc = pool.allocator
        assert pool.n_head_blocks == base + granted + debt
        refs = alloc.refcounts()
        assert alloc.used == sum(refs.values()) == view.used
        assert view.used == sum(len(view.seqs[s].bases) * gs for s in live)
        assert alloc.physical_used == len(refs)
        assert alloc.free_blocks == pool.n_head_blocks - len(refs)
        free_set: set = set()
        prev_end = -1
        for s, e in alloc.free_ranges():
            assert 0 <= s < e <= alloc.n_blocks
            assert s > prev_end, "free list must stay sorted + coalesced"
            prev_end = e
            free_set.update(range(s, e))
        assert len(free_set) == alloc.free_blocks
        assert not free_set & refs.keys()
        for sid in live:
            sc = view.seqs[sid]
            assert sc.shared <= len(sc.bases)
            assert all(b + gs <= pool.n_head_blocks for b in sc.bases)
        states.append(_state(pool))
    for sid in list(live):
        view.free_seq(sid)
    if granted:
        debt += granted - pool.shrink(granted)
    assert pool.shrink(debt) == debt, "idle tail settles all debt"
    assert pool.n_head_blocks == base and pool.allocator.used == 0
    states.append(_state(pool))
    return states


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 5), st.integers(1, 64)),
                min_size=1, max_size=50))
def test_pool_sharing_interleaving(ops):
    """Random interleavings of sequence allocation, frees, prefix sharing,
    copy-on-write appends and the fused-grant grow/shrink/debt algebra
    keep every allocator invariant exact on the port, and pass through
    the JAX package's states step for step; the port's copied pages
    equal the reference's."""
    jpool = J.UnifiedKVPool(512, 16)
    tpool = T.UnifiedKVPool(512, 16, device="cpu")
    for pool in (jpool, tpool):
        # distinct page contents, so a copy-on-write that copied the
        # wrong group shows
        k = np.arange(pool.k.shape[0] * 16 * 16, dtype=np.float32)\
            .reshape(pool.k.shape[0], 16, 16) % 251
        if pool is tpool:
            tpool.k.copy_(torch.from_numpy(k))
            tpool.v.copy_(torch.from_numpy(-k))
        else:
            jpool.k = jnp.asarray(k, jpool.k.dtype)
            jpool.v = jnp.asarray(-k, jpool.v.dtype)
    jstates = _sharing_run(
        jpool, jconfig.replace(jconfigs.get_reduced("qwen2-7b"),
                               head_dim=16), ops)
    tstates = _sharing_run(
        tpool, tconfig.replace(tconfigs.get_reduced("qwen2-7b"),
                               head_dim=16), ops)
    assert tstates == jstates
    np.testing.assert_array_equal(
        tpool.k.float().numpy(), np.asarray(jpool.k.astype(jnp.float32)))
    np.testing.assert_array_equal(
        tpool.v.float().numpy(), np.asarray(jpool.v.astype(jnp.float32)))
