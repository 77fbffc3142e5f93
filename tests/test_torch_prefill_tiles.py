"""The tile schedule of the tensor-core prefill kernels, replayed in numpy.

The bf16 paths of ``csrc/flash_prefill.cu`` and ``csrc/paged_prefill.cu``
run only on the card.  This file replays what they do on the CPU, at
reduced shapes, with inputs made from a seed with numpy:

* which query rows a 64-row tile holds (dense: 64 consecutive positions
  of one (b, h); paged: rows r = c*group + g of one kv head, the Pallas
  kernel's packing) and each row's absolute position;
* which 64-token key tiles it walks (dense: from the window's first key
  rounded down to 64 up to the tile's diagonal; paged: four head-blocks
  per tile gathered through ``phys``, stopping at the tile's last query
  position, blocks past the stop repeating the tile's first block), and
  which tiles need the mask at all;
* the online softmax tile by tile in log2 units (the scale folded into
  the exponent), with P cast to the working type before P·V and f32
  accumulation, as the kernel does;
* the shared-memory slabs at head dims 64, 96 and 128: 64-column atoms
  with the 128-byte swizzle, hd 96 padded to two atoms whose last 32
  columns TMA zero-fills (K, V) or nobody writes (Q), S summed over
  hd / 16 k-steps only, P V at n128, 96 columns written back.

The replay is held to the port's plain versions, to the JAX package's
``causal_attention`` and ``fused_paged_chunk_attention``, and to the
Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs
them).  Tolerances are ``tests/test_kernels.py::_tol``'s: float32 2e-5;
bfloat16 (P rounded to bf16 here, the probabilities after
normalisation in the plain versions) 2e-2.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill as pallas_flash
from repro.kernels.flash_prefill import \
    fused_paged_flash_prefill as pallas_paged
from repro.models.layers import causal_attention as jax_causal
from repro.serving.cache_ops import fused_paged_chunk_attention as jax_chunk
from repro_torch.kernels import flash_prefill as fp
from repro_torch.paging import resolve_physical_blocks

torch.set_num_threads(2)

ROWS = KEYS = 64            # TC_ROWS, TC_KEYS (attn_common.cuh)
BT = 16                     # BLOCK_TOKENS: tokens of a head-block
BLOCKS_PER_TILE = KEYS // BT
NEG_INF = np.float32(-1e30)
LOG2E = 1.4426950408889634
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _bf16(x):
    """x rounded to bfloat16, as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# the schedule (FlashAddr / PagedAddr)
# ---------------------------------------------------------------------------
def flash_tiles(S, window):
    """Query tiles in launch order (blockIdx.z = 0 first: the longest
    causal walk), each ``(q0, k_begin, n_tiles)``."""
    n_q = _cdiv(S, ROWS)
    for z in range(n_q):
        q0 = (n_q - 1 - z) * ROWS
        k_end = min(S, q0 + ROWS)
        k_begin = (max(0, q0 - window + 1) // KEYS * KEYS) if window else 0
        yield q0, k_begin, _cdiv(k_end - k_begin, KEYS)


def flash_keep(t, pos, S, window):
    keep = (t <= pos) & (t < S)
    if window:
        keep &= t > pos - window
    return keep


def flash_tile_masked(q0, t0, S, window):
    return (t0 + KEYS - 1 > q0 or t0 + KEYS > S
            or bool(window and t0 <= q0 + ROWS - 1 - window))


def paged_tiles(C, group, off, max_blocks):
    """Row tiles of one (b, kv head) in launch order, each ``(r0,
    n_blocks, n_tiles)``: rows r0 .. r0+63 of the C*group rows."""
    rows = C * group
    n_r = _cdiv(rows, ROWS)
    for z in range(n_r):
        r0 = (n_r - 1 - z) * ROWS
        last = off + (min(rows, r0 + ROWS) - 1) // group
        n_blocks = min(last // BT + 1, max_blocks)
        yield r0, n_blocks, _cdiv(n_blocks, BLOCKS_PER_TILE)


def paged_tile_blocks(it, n_blocks):
    """Table slots gathered into key tile ``it``: four head-blocks; a slot
    past the stop repeats the tile's first block (masked)."""
    j0 = it * BLOCKS_PER_TILE
    return [j if j < n_blocks else j0 for j in range(j0, j0 + BLOCKS_PER_TILE)]


def paged_tile_masked(it, pos0, n_blocks):
    return (it * KEYS + KEYS - 1 > pos0
            or (it + 1) * BLOCKS_PER_TILE > n_blocks)


STAGES = 3                  # TC_STAGES: depth of the K and V rings


def ring_protocol(n, stages=STAGES):
    """Replay the mbarrier protocol of one CTA over a walk of ``n``
    key tiles: the producer thread (K one tile ahead of V, each load
    waiting for the consumers' release of the stage's previous tile) and
    the consumer warpgroup (S of tile j beside P V of tile j-1, releases
    in the kernel's order).  Raises on a deadlock, and on a wait whose
    barrier is a phase ahead of it (parity would misread it).  Returns
    the completions per (ring, barrier, stage)."""
    done = {(r, b, st): 0 for r in "kv" for b in ("full", "empty")
            for st in range(stages)}

    def wait(ring, bar, gi, need):   # completion `need` of (ring, stage)
        return ("wait", (ring, bar, gi % stages), need)

    def arrive(ring, bar, gi):
        return ("arrive", (ring, bar, gi % stages), None)

    def producer():
        order = [("k", 0)]
        for it in range(n):
            order += [("k", it + 1)] if it + 1 < n else []
            order += [("v", it)]
        for ring, it in order:
            if it >= stages:
                yield wait(ring, "empty", it, it // stages)
            yield arrive(ring, "full", it)          # expect_tx + TMA lands

    def consumer():
        yield wait("k", "full", 0, 1)
        yield arrive("k", "empty", 0)
        for it in range(1, n):
            yield wait("k", "full", it, it // stages + 1)
            yield wait("v", "full", it - 1, (it - 1) // stages + 1)
            yield arrive("k", "empty", it)
            yield arrive("v", "empty", it - 1)
        yield wait("v", "full", n - 1, (n - 1) // stages + 1)
        yield arrive("v", "empty", n - 1)

    actors = [producer(), consumer()]
    pending = [next(a) for a in actors]
    while any(x is not None for x in pending):
        moved = False
        for i, op in enumerate(pending):
            if op is None:
                continue
            kind, key, need = op
            if kind == "wait":
                assert done[key] <= need, f"{key} a phase ahead of its waiter"
                if done[key] < need:
                    continue
            else:
                done[key] += 1
            pending[i] = next(actors[i], None)
            moved = True
        assert moved, f"deadlock: {pending}"
    return done


# ---------------------------------------------------------------------------
# the arithmetic (tc_consume / online_softmax)
# ---------------------------------------------------------------------------
def walk(q, tiles, scale, bf16):
    """One warpgroup's walk: q [64, hd]; tiles of (k [64, hd], v [64, hd],
    keep [64, 64] or None for an unmasked tile).  The running max in
    log2 units (scores times scale * log2 e), taken over the raw masked
    scores; P in the working type before P·V, f32 accumulation."""
    m = np.full(ROWS, NEG_INF, np.float32)
    l = np.zeros(ROWS, np.float32)
    o = np.zeros((ROWS, q.shape[1]), np.float32)
    scale_log2 = np.float32(np.float32(scale) * np.float32(LOG2E))
    for k, v, keep in tiles:
        s = (q @ k.T).astype(np.float32)
        if keep is not None:
            s = np.where(keep, s, NEG_INF)
        mn = np.maximum(m, s.max(1) * scale_log2)
        corr = np.exp2(m - mn)
        p = np.exp2(s * scale_log2 - mn[:, None])
        l = l * corr + p.sum(1)
        o = o * corr[:, None] + (_bf16(p) if bf16 else p) @ v
        m = mn
    out = o / np.maximum(l, np.float32(1e-30))[:, None]
    return _bf16(out) if bf16 else out


def replay_flash(q, k, v, window, bf16):
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    out = np.zeros_like(q)
    for q0, k_begin, n_tiles in flash_tiles(S, window):
        pos = q0 + np.arange(ROWS)
        valid = pos < S
        for b in range(B):
            for h in range(H):
                qt = np.zeros((ROWS, hd), np.float32)
                qt[valid] = q[b, pos[valid], h]
                tiles = []
                for it in range(n_tiles):
                    t = k_begin + it * KEYS + np.arange(KEYS)
                    kt = np.zeros((KEYS, hd), np.float32)   # TMA zero fill
                    vt = np.zeros((KEYS, hd), np.float32)
                    kt[t < S] = k[b, t[t < S], h // group]
                    vt[t < S] = v[b, t[t < S], h // group]
                    keep = (flash_keep(t[None], pos[:, None], S, window)
                            if flash_tile_masked(q0, t[0], S, window)
                            else None)
                    tiles.append((kt, vt, keep))
                out[b, pos[valid], h] = walk(qt, tiles, 1 / math.sqrt(hd),
                                             bf16)[valid]
    return out


def gather_tile(pool, phys_row, it, n_blocks):
    """The 64 x hd key (or value) tile ``it``: four head-blocks through
    ``phys_row`` ([max_blocks] ids of one (b, kv head))."""
    return np.concatenate([pool[phys_row[j]]
                           for j in paged_tile_blocks(it, n_blocks)])


def replay_paged(q, pool_k, pool_v, phys, q_offset, bf16):
    B, C, H, hd = q.shape
    n_kv, max_blocks = phys.shape[1:]
    group = H // n_kv
    out = np.zeros_like(q)
    for b in range(B):
        off = int(q_offset[b])
        for h in range(n_kv):
            for r0, n_blocks, n_tiles in paged_tiles(C, group, off,
                                                     max_blocks):
                r = r0 + np.arange(ROWS)
                valid = r < C * group
                c, g = r[valid] // group, r[valid] % group
                pos = off + r // group
                qt = np.zeros((ROWS, hd), np.float32)
                qt[valid] = q[b, c, h * group + g]
                tiles = []
                for it in range(n_tiles):
                    t = it * KEYS + np.arange(KEYS)
                    keep = ((t[None] <= pos[:, None])
                            & (t[None] < n_blocks * BT)
                            if paged_tile_masked(it, pos[0], n_blocks)
                            else None)
                    tiles.append((gather_tile(pool_k, phys[b, h], it, n_blocks),
                                  gather_tile(pool_v, phys[b, h], it, n_blocks),
                                  keep))
                out[b, c, h * group + g] = walk(qt, tiles, 1 / math.sqrt(hd),
                                                bf16)[valid]
    return out


# ---------------------------------------------------------------------------
# the schedule itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,window", [(272, None), (416, None), (100, 32),
                                      (300, 100), (272, 48), (64, None)])
def test_flash_schedule_visits_exactly_each_rows_keys(S, window):
    """Every row of every query tile meets each key it attends to once,
    in the tiles it walks; a tile left unmasked needs no mask; the walk
    ends at the tile's diagonal; causal walks launch longest first."""
    walks = []
    for q0, k_begin, n_tiles in flash_tiles(S, window):
        walks.append(n_tiles)
        pos = q0 + np.arange(ROWS)
        seen = np.zeros((ROWS, S + KEYS), int)
        for it in range(n_tiles):
            t0 = k_begin + it * KEYS
            t = t0 + np.arange(KEYS)
            keep = flash_keep(t[None], pos[:, None], S, window)
            if not flash_tile_masked(q0, t0, S, window):
                assert keep.all()
            seen[:, t] += keep
        assert k_begin + (n_tiles - 1) * KEYS <= min(S, q0 + ROWS) - 1
        for i in np.flatnonzero(pos < S):
            lo = max(0, pos[i] - window + 1) if window else 0
            want = np.zeros(S + KEYS, int)
            want[lo:pos[i] + 1] = 1
            np.testing.assert_array_equal(seen[i], want)
    if window is None:            # a window bounds every walk alike
        assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("C,group,off,max_blocks", [
    (64, 7, 0, 4), (64, 7, 832, 60), (64, 7, 37, 8), (64, 1, 100, 12),
    (16, 2, 5, 2), (64, 7, 960, 60)])        # the last: the table caps it
def test_paged_schedule_packs_rows_and_stops_at_the_last_query(
        C, group, off, max_blocks):
    """Row r of a tile is query head g = r % group at chunk position
    r // group (the Pallas kernel's packing: at C 64, group 7 the 448
    rows are seven tiles); the key walk covers every position up to the
    tile's last query that the table holds, and stops there."""
    rows = C * group
    covered = []
    for r0, n_blocks, n_tiles in paged_tiles(C, group, off, max_blocks):
        r = np.arange(r0, min(rows, r0 + ROWS))
        covered += r.tolist()
        last = off + (r[-1]) // group
        assert n_blocks == min(last // BT + 1, max_blocks)
        assert (n_tiles - 1) * BLOCKS_PER_TILE < n_blocks <= n_tiles * BLOCKS_PER_TILE
        pos = off + r // group
        for it in range(n_tiles):
            t = it * KEYS + np.arange(KEYS)
            keep = (t[None] <= pos[:, None]) & (t[None] < n_blocks * BT)
            if not paged_tile_masked(it, pos[0], n_blocks):
                assert keep.all()
        # each row attends to min(pos + 1, table length) positions
        n_keys = np.minimum(pos + 1, max_blocks * BT)
        visited = np.minimum(pos + 1, n_blocks * BT)
        np.testing.assert_array_equal(visited, n_keys)
    assert sorted(covered) == list(range(rows))
    if (C, group) == (64, 7):
        assert _cdiv(rows, ROWS) == 7


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16])
@pytest.mark.parametrize("stages", [2, STAGES])
def test_ring_protocol_runs_to_the_end(n, stages):
    """The K/V rings' barriers carry a walk of any length to its end:
    no deadlock, no wait a phase behind its barrier, every tile's K and
    V stage filled and released once."""
    done = ring_protocol(n, stages)
    for ring in "kv":
        for bar in ("full", "empty"):
            assert sum(done[(ring, bar, st)] for st in range(stages)) == n


def test_paged_gather_reads_the_tables_blocks():
    """Key tile ``it`` holds positions 64*it .. 64*it+63 of the row's
    table, block j from pool[phys[j]]; slots past the stop repeat the
    tile's first block."""
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((40, BT, 8)).astype(np.float32)
    phys_row = rng.permutation(40)[:10].astype(np.int32)
    n_blocks = 6
    flat = pool[phys_row].reshape(-1, 8)        # the row's positions
    tiles = [gather_tile(pool, phys_row, it, n_blocks) for it in range(2)]
    np.testing.assert_array_equal(tiles[0], flat[:KEYS])
    np.testing.assert_array_equal(tiles[1][:2 * BT], flat[KEYS:KEYS + 2 * BT])
    np.testing.assert_array_equal(tiles[1][2 * BT:3 * BT], pool[phys_row[4]])
    np.testing.assert_array_equal(tiles[1][3 * BT:], pool[phys_row[4]])


@pytest.mark.parametrize("hd,fused_overflows", [(64, True), (128, False)])
def test_masked_exponent_is_exact_before_a_rows_first_valid_key(
        hd, fused_overflows):
    """A row whose keys so far are all masked has the max
    fl(NEG_INF * scale_log2).  In a masked tile the kernel rounds each
    score's product on its own, as the max's was, so such a score's
    exponent is exactly 0 (the replay's `walk` does the same).  Folded
    into one fused multiply-add, the exponent would be the product's
    rounding error instead: at hd 64 it is positive and 2^x overflows
    float32, so the row's sum and output turn to inf and then NaN."""
    scale_log2 = np.float32(np.float32(1 / math.sqrt(hd)) * np.float32(LOG2E))
    mn = np.float32(NEG_INF * scale_log2)
    separate = np.float32(NEG_INF * scale_log2) - mn
    assert separate == 0 and np.exp2(separate) == 1
    fused = float(NEG_INF) * float(scale_log2) - float(mn)   # exact in f64
    assert (fused > 128) == fused_overflows, fused


# ---------------------------------------------------------------------------
# the replay against the plain versions, the references and Pallas
# ---------------------------------------------------------------------------
def _dtype(name):
    return {"float32": (torch.float32, jnp.float32),
            "bfloat16": (torch.bfloat16, jnp.bfloat16)}[name]


@pytest.mark.parametrize("dtype,B,S,H,KV,hd,window,block", [
    ("float32", 1, 272, 4, 2, 64, None, 136),   # a ragged last key tile
    ("float32", 1, 272, 7, 1, 64, None, 272),   # group 7
    ("float32", 2, 128, 4, 4, 64, 48, 64),      # group 1, window 48
    ("bfloat16", 1, 272, 4, 4, 64, None, 136),  # zamba2's group 1, hd 64
    ("bfloat16", 1, 200, 7, 1, 128, 48, 100),   # group 7, hd 128, window
    ("bfloat16", 1, 272, 4, 4, 64, 48, 136),    # hd 64, window 48: rows
    # whose first key tile is wholly masked
    ("bfloat16", 1, 272, 4, 4, 96, None, 136),  # phi-3-vision's hd 96
    ("float32", 1, 200, 4, 2, 96, 48, 100),
    ("bfloat16", 1, 128, 12, 1, 128, None, 64), # group 12
])
def test_flash_replay_matches_plain_reference_and_pallas(
        dtype, B, S, H, KV, hd, window, block):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    bf16 = dtype == "bfloat16"
    if bf16:
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    tdt, jdt = _dtype(dtype)
    out = replay_flash(q, k, v, window, bf16)
    plain = fp.flash_prefill(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                             window=window)
    ref = jax_causal(*(jnp.asarray(x, jdt) for x in (q, k, v)), window=window)
    pal = pallas_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                       block_q=block, block_k=block, window=window,
                       interpret=True)
    for other in (plain.float().numpy(), np.asarray(ref, np.float32),
                  np.asarray(pal, np.float32)):
        np.testing.assert_allclose(out, other, **TOL[dtype])


@pytest.mark.parametrize("seed", [4, 18])
def test_flash_replay_stays_near_the_f32_result_at_s1024(seed):
    """Full-width qwen2-7b heads (28/4, hd 128) over 2 x 1024 bf16
    tokens.  The kernel's numerics (f32 scores, P rounded to bf16 before
    P·V) stay within the bf16 tolerance of the plain version run in
    float32 on the same inputs, which is what the card tests hold the
    bf16 prefill kernels to, and closer to it than the bf16 plain
    version, which rounds its scores to bf16 as the JAX reference
    does."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((2, 1024, n, 128), generator=g).bfloat16()
               for n in (28, 4, 4))
    out = replay_flash(*(x.float().numpy() for x in (q, k, v)), None, True)
    ref = fp.flash_prefill(q.float(), k.float(), v.float()).numpy()
    err = np.abs(out - ref).max()
    assert err <= TOL["bfloat16"]["atol"]
    assert err < np.abs(fp.flash_prefill(q, k, v).float().numpy() - ref).max()


@pytest.mark.parametrize("dtype,C,H,n_kv,hd,offs,max_blocks", [
    ("float32", 16, 4, 2, 64, (0, 37, 832), 56),     # group 2
    ("float32", 64, 7, 1, 64, (0, 832, 100), 60),    # group 7: 7 row tiles
    ("float32", 16, 4, 4, 64, (0, 21, 150), 10),     # group 1; row 2's
    # queries reach past the 10-block table: the walk stops at the table,
    # its last tile half repeated blocks, masked by position
    ("bfloat16", 64, 7, 1, 128, (0, 832, 100), 60),  # group 7, hd 128
    ("bfloat16", 64, 4, 4, 64, (0, 50, 130), 16),    # zamba2's group 1
    ("bfloat16", 64, 4, 4, 96, (0, 50, 130), 16),    # hd 96, group 1
    ("float32", 16, 8, 2, 96, (0, 37, 200), 20),     # hd 96, group 4
    ("bfloat16", 16, 16, 1, 64, (0, 21, 90), 10),    # group 16
])
def test_paged_replay_matches_plain_reference_and_pallas(
        dtype, C, H, n_kv, hd, offs, max_blocks):
    """Rows of two models (layers 0 and 1 of one arena), the last a
    padded row (table -1: every block reads block 0, hidden by the
    causal mask only where the reference hides it)."""
    rng = np.random.default_rng(1)
    B = len(offs) + 1
    layers = 2
    n_groups = B * max_blocks + 1
    N = n_groups * layers * n_kv
    pool_k, pool_v = (rng.standard_normal((N, BT, hd)).astype(np.float32)
                      for _ in range(2))
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    bf16 = dtype == "bfloat16"
    if bf16:
        q, pool_k, pool_v = _bf16(q), _bf16(pool_k), _bf16(pool_v)
    bases = (1 + rng.permutation(n_groups - 1)[:B * max_blocks]) * layers * n_kv
    table = bases.reshape(B, max_blocks).astype(np.int32)
    table[-1] = -1
    q_offset = np.array(list(offs) + [0], np.int32)
    phys = torch.cat([
        resolve_physical_blocks(torch.from_numpy(table[:2]), 0, n_kv),
        resolve_physical_blocks(torch.from_numpy(table[2:]), 1, n_kv)]).numpy()
    tdt, jdt = _dtype(dtype)
    out = replay_paged(q, pool_k, pool_v, phys, q_offset, bf16)
    plain = fp.fused_paged_flash_prefill(
        *(torch.from_numpy(x).to(tdt) for x in (q, pool_k, pool_v)),
        torch.from_numpy(phys), torch.from_numpy(q_offset))
    args = [jnp.asarray(x, jdt) for x in (q, pool_k, pool_v)] + [
        jnp.asarray(phys), jnp.asarray(q_offset)]
    ref = jax_chunk(*args)
    pal = pallas_paged(*args, interpret=True)
    for other in (plain.float().numpy(), np.asarray(ref, np.float32),
                  np.asarray(pal, np.float32)):
        np.testing.assert_allclose(out, other, **TOL[dtype])


# ---------------------------------------------------------------------------
# the shared-memory slabs (attn_common.cuh: TcSmem, the TMA boxes, the
# 128-byte swizzle) at head dims 64, 96 and 128
# ---------------------------------------------------------------------------
ATOM = 64                   # bf16 columns of a 128-byte swizzle atom


def atoms(hd):
    return -(-hd // ATOM)


def tma_tile(x, hd):
    """A [64, hd] tile loaded by one TMA box per atom (box 64 rows x 64
    columns over a map whose inner extent is hd): atom a holds columns
    64a .. 64a + 63, those at or past hd zero-filled; 8-column chunk c of
    row r stored at chunk c ^ (r % 8).  Returns [atoms, 64, 8, 8] and
    the bytes the box writes (expect_tx)."""
    na = atoms(hd)
    slab = np.empty((na, KEYS, 8, 8), np.float32)
    for a in range(na):
        for r in range(KEYS):
            for c in range(8):
                cols = a * ATOM + 8 * c + np.arange(8)
                slab[a, r, c ^ (r % 8)] = np.where(
                    cols < hd, x[r, np.minimum(cols, hd - 1)], 0.0)
    return slab, na * KEYS * ATOM * 2


def stage_q(x, hd):
    """Q by cp.async: hd / 8 chunks of each row at their swizzled place;
    the padding chunks of hd 96 keep what shared memory held (NaN)."""
    slab = np.full((atoms(hd), ROWS, 8, 8), np.nan, np.float32)
    for r in range(ROWS):
        for c in range(hd // 8):
            slab[c // 8, r, (c % 8) ^ (r % 8)] = x[r, 8 * c:8 * c + 8]
    return slab


def read_cols(slab, rows, c0, n):
    """Logical columns c0 .. c0 + n - 1 (n a multiple of 8, within one
    atom) of ``rows``, through the swizzle, as a wgmma descriptor reads
    them."""
    a, lc = c0 // ATOM, (c0 % ATOM) // 8
    return np.concatenate([slab[a, rows, (lc + i) ^ (rows % 8)]
                           for i in range(n // 8)], axis=1)


@pytest.mark.parametrize("hd", [64, 96, 128])
def test_slabs_pad_hd96_to_two_atoms(hd):
    rng = np.random.default_rng(hd)
    q, k, v = (rng.standard_normal((64, hd)).astype(np.float32)
               for _ in range(3))
    qs = stage_q(q, hd)
    ks, k_bytes = tma_tile(k, hd)
    vs, v_bytes = tma_tile(v, hd)
    hdp = atoms(hd) * ATOM
    assert k_bytes == v_bytes == (16384 if hd > 64 else 8192)
    rows = np.arange(64)
    # S = Q K^T: hd / 16 k-steps, step kk from atom kk / 4
    s = sum(read_cols(qs, rows, 16 * kk, 16) @ read_cols(ks, rows, 16 * kk,
                                                         16).T
            for kk in range(hd // 16))
    assert np.isfinite(s).all()          # Q's padding is never read
    np.testing.assert_allclose(s, q @ k.T, rtol=1e-5, atol=1e-5)
    # O += P V at n = hdp over V's token-major slab
    p = rng.random((64, KEYS)).astype(np.float32)
    vfull = np.concatenate([read_cols(vs, rows, c0, 8)
                            for c0 in range(0, hdp, 8)], axis=1)
    o = p @ vfull
    np.testing.assert_allclose(o[:, :hd], p @ v, rtol=1e-5, atol=1e-5)
    assert not o[:, hd:].any()           # TMA's zero columns
    # write-back through the Q slab: hd / 8 accumulator groups staged at
    # their swizzled chunks, read back as hd / 8 16-byte row chunks
    stage = stage_q(np.full((ROWS, hd), np.nan, np.float32), hd)
    for r in range(ROWS):
        for i in range(hd // 8):
            stage[i // 8, r, (i % 8) ^ (r % 8)] = o[r, 8 * i:8 * i + 8]
    out = np.concatenate([stage[c // 8, rows, (c % 8) ^ (rows % 8)]
                          for c in range(hd // 8)], axis=1)
    np.testing.assert_array_equal(out, o[:, :hd])
