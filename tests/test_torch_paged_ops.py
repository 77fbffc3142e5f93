"""Paged-pool ops of the port against the JAX package, on the CPU.

* ``resolve_physical_blocks`` and ``write_tokens`` give exactly the
  JAX package's ids and arenas, including −1 table entries and
  positions past the table (JAX drops those writes; torch must mask
  them explicitly).
* ``copy_block_groups`` (copy-on-write of a shared prefix block, and
  the later cross-pool migration) gives exactly the JAX package's
  pages within one pool — chained copies included, which must gather
  before they scatter — from another pool, and in place on a pool's
  arena after a ``shrink`` and ``grow``.
* The plain versions of the three CUDA kernels equal the JAX oracles
  and the Pallas kernels (interpret mode) on cross-model tables:
  float32 within 2e-5, bfloat16 within 2e-2 (``tests/test_kernels.py``
  ``_tol``: the two frameworks round bf16 at other places), at the
  kernels' head dims 64, 96 (phi-3-vision-4.2b) and 128, groups of 1
  to 16 (command-r-plus-104b's 12, qwen3-moe-235b-a22b's 16).
* On CPU tensors each wrapper runs its plain version and launches
  nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import paging as jpaging
from repro.kernels.flash_prefill import (flash_prefill as pallas_flash,
                                         fused_paged_flash_prefill)
from repro.kernels.paged_attention import (
    fused_paged_decode_attention as pallas_decode)
from repro.models.layers import causal_attention as jcausal
from repro.serving import cache_ops as jops
from repro_torch import paging as tpaging
from repro_torch.kernels import flash_prefill as tfp
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.serving import cache_ops as tops

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, jdt, tdt):
    """One numpy array as a JAX array and a torch tensor of one dtype
    (bf16 rounded once, in numpy's float32 → the framework's bf16)."""
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# cross-model tables: rows of two models at different layer offsets in
# one arena (tests/test_kernels.py::test_fused_paged_flash_prefill_*)
T0 = np.array([[0, 8, -1, -1], [16, 24, 32, -1]], np.int32)
T1 = np.array([[40, 48, -1, -1], [56, 64, 72, 80]], np.int32)


def _phys(kv):
    j = jnp.concatenate([jpaging.resolve_physical_blocks(jnp.asarray(T0), 0, kv),
                         jpaging.resolve_physical_blocks(jnp.asarray(T1), 1, kv)])
    t = torch.cat([tpaging.resolve_physical_blocks(torch.from_numpy(T0), 0, kv),
                   tpaging.resolve_physical_blocks(torch.from_numpy(T1), 1, kv)])
    return j, t


@pytest.mark.parametrize("layer,n_kv", [(0, 2), (3, 4)])
def test_resolve_physical_blocks_exact(layer, n_kv):
    table = np.array([[5, -1, 7], [-1, -1, -1], [0, 12, 30]], np.int32)
    j = jpaging.resolve_physical_blocks(jnp.asarray(table), layer, n_kv)
    t = tpaging.resolve_physical_blocks(torch.from_numpy(table), layer, n_kv)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # leading batch dims resolve the same
    j3 = jpaging.resolve_physical_blocks(jnp.asarray(table[None]), layer, n_kv)
    t3 = tpaging.resolve_physical_blocks(torch.from_numpy(table[None]),
                                         layer, n_kv)
    np.testing.assert_array_equal(np.asarray(j3), t3.numpy())


def test_write_tokens_exact_including_dropped_slots():
    rng = np.random.default_rng(0)
    n, bt, hd, kv = 64, 16, 8, 2
    pool = rng.standard_normal((n, bt, hd)).astype(np.float32)
    # row 0: a −1 block mid-table; row 1: positions run past the table;
    # row 2: an all −1 (padded) row
    table = np.array([[4, -1, 12], [20, 28, 36], [-1, -1, -1]], np.int32)
    start = np.array([10, 40, 0], np.int32)
    S = 12
    k_new = rng.standard_normal((3, S, kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((3, S, kv, hd)).astype(np.float32)
    for layer in (0, 1):
        jk, jv = jops.write_tokens(jnp.asarray(pool), jnp.asarray(pool),
                                   jnp.asarray(k_new), jnp.asarray(v_new),
                                   jnp.asarray(table), jnp.asarray(start),
                                   layer, kv)
        tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
        tops.write_tokens(tk, tv, torch.from_numpy(k_new),
                          torch.from_numpy(v_new), torch.from_numpy(table),
                          torch.from_numpy(start), layer, kv)
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        # something was written and something was dropped
        assert not np.array_equal(tk.numpy(), pool)
    slots = tops.token_slots(table, start, S, bt, "cpu")
    # row 0: 6 tokens land in block 0, 6 in the −1 block (dropped);
    # row 1: 8 in block 2, 4 past the table (dropped); row 2: none.
    # The plan has one entry per new token; a dropped one repeats the
    # first kept write
    assert len(slots.src) == 3 * S and bool(slots.live)
    assert len(set(slots.src.tolist())) == 6 + 8


@pytest.mark.parametrize("case", ["same_pool", "chained", "other_pool"])
def test_copy_block_groups_exact(case):
    rng = np.random.default_rng(1)
    n, bt, hd, kv, layers = 96, 16, 8, 2, 3          # groups of 6 blocks
    pk, pv = (rng.standard_normal((n, bt, hd)).astype(np.float32)
              for _ in range(2))
    src, dst = {"same_pool": ([0, 30], [48, 84]),
                # 0 → 6 and 6 → 12: the second copy reads group 6
                # before the first one overwrites it
                "chained": ([0, 6], [6, 12]),
                "other_pool": ([0, 18, 6], [90, 30, 36])}[case]
    extra = {}
    if case == "other_pool":
        sk, sv = (rng.standard_normal((24, bt, hd)).astype(np.float32)
                  for _ in range(2))
        extra = dict(src_k=sk, src_v=sv)
    jk, jv = jops.copy_block_groups(
        jnp.asarray(pk), jnp.asarray(pv), src, dst, kv, layers,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out = tops.copy_block_groups(
        tk, tv, src, dst, kv, layers,
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert out[0] is tk and out[1] is tv, "the copy is in place"
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert not np.array_equal(tk.numpy(), pk)


def test_copy_block_groups_lands_in_the_arena():
    """After a ``shrink`` and ``grow`` the pool's ``k``/``v`` are views
    onto its arena buffers again; the copy writes through them, so the
    pages survive the next re-slicing of the arena."""
    from repro.serving.kvcache import UnifiedKVPool as JPool
    from repro_torch.serving.kvcache import UnifiedKVPool as TPool
    rng = np.random.default_rng(2)
    n, bt, hd, kv, layers = 64, 16, 8, 2, 2          # groups of 4 blocks
    pk, pv = (rng.standard_normal((n, bt, hd)).astype(np.float32)
              for _ in range(2))
    tpool = TPool(n, hd, dtype=torch.float32, device="cpu")
    tpool.k.copy_(torch.from_numpy(pk))
    tpool.v.copy_(torch.from_numpy(pv))
    assert tpool.shrink(16) == 16 and tpool.grow(16) == 16
    jpool = JPool(n, hd, dtype=jnp.float32)
    jpool.k, jpool.v = jnp.asarray(pk), jnp.asarray(pv)
    # the arena's grown rows read zero in both packages: an idle arena
    # starts from fresh zeros
    np.testing.assert_array_equal(tpool.k.numpy(), np.zeros_like(pk))
    tpool.k.copy_(torch.from_numpy(pk))
    tpool.v.copy_(torch.from_numpy(pv))
    jk, jv = jops.copy_block_groups(jpool.k, jpool.v, [0, 8], [52, 60],
                                    kv, layers)
    tops.copy_block_groups(tpool.k, tpool.v, [0, 8], [52, 60], kv, layers)
    assert tpool.k.data_ptr() == tpool._k_buf.data_ptr()
    tpool._view_arena()
    np.testing.assert_array_equal(tpool._k_buf[:n].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tpool._v_buf[:n].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tpool.k.numpy(), np.asarray(jk))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,kv,hd", [(4, 2, 64), (8, 2, 32), (4, 4, 96),
                                     (24, 2, 64), (32, 2, 64), (16, 1, 128)])
def test_decode_plain_matches_oracle_and_pallas(dt, h, kv, hd):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    pk = rng.standard_normal((256, 16, hd)).astype(np.float32)
    pv = rng.standard_normal((256, 16, hd)).astype(np.float32)
    q = rng.standard_normal((4, h, hd)).astype(np.float32)
    lens = np.array([20, 41, 9, 64], np.int32)
    jphys, tphys = _phys(kv)
    (jpk, tpk), (jpv, tpv), (jq, tq) = (_both(a, jdt, tdt) for a in (pk, pv, q))
    plain = tpa.decode_plain(tq, tpk, tpv, tphys, torch.from_numpy(lens))
    oracle = jpaging.fused_paged_decode_attention(jq, jpk, jpv, jphys,
                                                  jnp.asarray(lens))
    pallas = pallas_decode(jq, jpk, jpv, jphys, jnp.asarray(lens),
                           interpret=True)
    np.testing.assert_allclose(_np(plain), _np(oracle), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(plain), _np(pallas), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("c,h,kv,hd", [(8, 4, 2, 64), (4, 4, 4, 64),
                                       (4, 4, 4, 96), (4, 24, 2, 64),
                                       (4, 32, 2, 64)])
def test_chunk_plain_matches_oracle_and_pallas(dt, c, h, kv, hd):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    pk = rng.standard_normal((256, 16, hd)).astype(np.float32)
    pv = rng.standard_normal((256, 16, hd)).astype(np.float32)
    q = rng.standard_normal((4, c, h, hd)).astype(np.float32)
    offs = np.array([0, 17, 5, 33], np.int32)
    jphys, tphys = _phys(kv)
    (jpk, tpk), (jpv, tpv), (jq, tq) = (_both(a, jdt, tdt) for a in (pk, pv, q))
    plain = tfp.paged_prefill_plain(tq, tpk, tpv, tphys,
                                    torch.from_numpy(offs))
    oracle = jops.fused_paged_chunk_attention(jq, jpk, jpv, jphys,
                                              jnp.asarray(offs))
    pallas = fused_paged_flash_prefill(jq, jpk, jpv, jphys, jnp.asarray(offs),
                                       interpret=True)
    np.testing.assert_allclose(_np(plain), _np(oracle), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(plain), _np(pallas), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,hd,window", [(1, 64, 4, 4, 64, None),
                                                (2, 128, 8, 2, 64, None),
                                                (1, 128, 4, 2, 64, 32),
                                                (1, 64, 4, 4, 96, None),
                                                (1, 64, 24, 2, 64, None),
                                                (1, 64, 32, 2, 64, None)])
def test_flash_plain_matches_oracle_and_pallas(dt, b, s, h, kv, hd, window):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, jdt, tdt) for a in arrs)
    plain = tfp.flash_prefill_plain(tq, tk, tv, window=window)
    oracle = jcausal(jq, jk, jv, window=window)
    pallas = pallas_flash(jq, jk, jv, block_q=32, block_k=32, window=window,
                          interpret=True)
    np.testing.assert_allclose(_np(plain), _np(oracle), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(plain), _np(pallas), rtol=tol, atol=tol)


def test_single_model_views_match_reference():
    """The table-based views (one model's group-base table and layer)
    resolve and attend as the JAX package's cache_ops do."""
    rng = np.random.default_rng(5)
    pk = rng.standard_normal((256, 16, 64)).astype(np.float32)
    pv = rng.standard_normal((256, 16, 64)).astype(np.float32)
    q = rng.standard_normal((2, 4, 64)).astype(np.float32)
    qc = rng.standard_normal((2, 8, 4, 64)).astype(np.float32)
    lens = np.array([20, 41], np.int32)
    offs = np.array([0, 21], np.int32)
    t = torch.from_numpy
    j = jnp.asarray
    np.testing.assert_allclose(
        tops.paged_decode_attention(t(q), t(pk), t(pv), t(T1), t(lens), 1,
                                    2).numpy(),
        np.asarray(jops.paged_decode_attention(j(q), j(pk), j(pv), j(T1),
                                               j(lens), 1, 2)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        tops.paged_chunk_attention(t(qc), t(pk), t(pv), t(T1), t(offs), 1,
                                   2).numpy(),
        np.asarray(jops.paged_chunk_attention(j(qc), j(pk), j(pv), j(T1),
                                              j(offs), 1, 2)),
        rtol=2e-5, atol=2e-5)


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    pk = torch.from_numpy(rng.standard_normal((256, 16, 64)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, 4, 64)).astype(np.float32))
    qc = torch.from_numpy(rng.standard_normal((4, 8, 4, 64)).astype(np.float32))
    _, phys = _phys(2)
    lens = torch.tensor([3, 17, 30, 64], dtype=torch.int32)
    offs = torch.tensor([0, 3, 16, 40], dtype=torch.int32)
    before = ops.launch_counts()
    torch.testing.assert_close(
        tops.fused_paged_decode_attention(q, pk, pk, phys, lens),
        tpa.decode_plain(q, pk, pk, phys, lens), rtol=0, atol=0)
    torch.testing.assert_close(
        tops.fused_paged_chunk_attention(qc, pk, pk, phys, offs),
        tfp.paged_prefill_plain(qc, pk, pk, phys, offs), rtol=0, atol=0)
    torch.testing.assert_close(tops.flash_prefill(qc, qc[:, :, :2], qc[:, :, :2]),
                               tfp.flash_prefill_plain(qc, qc[:, :, :2],
                                                       qc[:, :, :2]),
                               rtol=0, atol=0)
    assert ops.launch_counts() == before
    # anything but all-CPU or all-one-CUDA-device operands is refused
    with pytest.raises(ValueError, match="operands"):
        ops.runs_kernel("x", q, torch.empty(1, device="meta"))
