"""The port's unified KV pool against the JAX package's, on the CPU.

One scripted sequence of alloc / append / free / grow / shrink / quota
moves is replayed on both packages; after every step the allocator's
free list, refcounts and usage, the views' quotas and tables, and the
arena size must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.serving import kvcache as J
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.serving import kvcache as T

torch.set_num_threads(2)


def _state(pool):
    a = pool.allocator
    views = {n: (v.quota, v.used, {s: (list(c.bases), c.n_tokens)
                                   for s, c in v.seqs.items()})
             for n, v in pool.views.items()}
    return (a.free_ranges(), a.refcounts(), a.used, a.physical_used,
            a.n_blocks, a.shrinkable_tail(), a.largest_free_range(),
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
    return out, tables


def test_pool_script_replays_identically():
    jpool = J.UnifiedKVPool(1200, 64, dtype=jnp.float32)
    tpool = T.UnifiedKVPool(1200, 64, dtype=torch.float32, device="cpu")
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
