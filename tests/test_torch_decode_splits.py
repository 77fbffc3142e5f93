"""The split-KV decode kernels' plan and arithmetic, replayed on the CPU.

The two decode kernels (``csrc/decode_splitkv.cuh``: kernel 1 over
float/bf16 head-blocks, kernel 5 over int8 K/V with per-token scales)
run only on the card.  Here the host's split planner
(``kernels.decode_splits``) is checked to read shapes alone, and a numpy
replay of the kernels' schedule — the grid's splits, a CTA's walk over
its split in ring chunks, the per-warp 16-key tiles of the tensor-core
body with P rounded to the fragment type (bf16, or f16 for int8), the
lane-per-key chunks of the float32 body, the warps' merge, each live
split's partial (m, l, acc) and the merge of the splits — is held to
the plain versions (``paging.fused_paged_decode_attention``,
``paged_int8_plain``, ``dense_int8_plain``) and to the Pallas kernels
in interpret mode, as ``tests/test_kernels.py`` runs them.  Rows of no
token, of one token, rows whose later splits are all empty and rows
much longer than one split are covered, at head dims 64, 96 and 128
and groups of 1 to 16.  Tolerance: float32 2e-5; bf16 2e-2 (the replay
rounds P to bf16, the references do not).

The layouts no compiler here checks are replayed too: the ring's
16-byte-unit swizzle (a permutation of each row's units at every row
width the kernels use, 8 consecutive rows of one unit on 8 distinct
bank groups), the tensor-core body's m16 tile at fragment level (which
lane holds which head, for groups of up to 8 and of 9-16), the
workspace's slots at ``SK_MAX_GROUP`` 16, the shared-memory layout
(``SkSmem``: bytes and CTAs an SM), and the Python mirrors of the
source's constants, read from the source text.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import \
    fused_paged_decode_attention as pallas_decode
from repro.kernels.paged_attention_int8 import \
    paged_decode_attention_int8 as pallas_int8
from repro_torch.kernels import decode_splits as dsp
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_attention_int8 as pi8
from repro_torch.paging import resolve_physical_blocks

torch.set_num_threads(2)

NEG_INF = np.float32(-1e30)
TOL = {"f32": 2e-5, "bf16": 2e-2}
BT = 16
SMS = 132            # an H100 SXM's SM count


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,n_kv,max_tok,bt", [
    (8, 4, 1024, 16),        # full-width qwen2-7b decode tick
    (8, 4, 4096, 16),        # the long-context point
    (8, 4, 544, None),       # the W8/KV8 step's dense layer
    (8, 32, 1024, 16),       # zamba2-1.2b's shared attention (group 1)
    (8, 2, 1024, 16),        # the reduced pool
    (1, 1, 100_000, 1),      # one pair, a huge cache, 1-token blocks
    (3, 2, 0, 16),           # an empty cache
    (4, 2, 320, 16),
])
def test_plan_respects_the_kernels_limits(rows, n_kv, max_tok, bt):
    split, n = dsp.plan_splits(rows, n_kv, max_tok, bt, SMS)
    assert split % dsp.ALIGN == 0 and split >= dsp.MIN_SPLIT
    assert n >= 1 and split * n >= max_tok
    assert split * (n - 1) < max(max_tok, 1)          # no split wholly past
    if bt is not None:
        assert split // bt + 2 <= dsp.MAX_IDS         # block ids fit smem
    if split > dsp.MIN_SPLIT:                         # it doubled: the grid
        assert rows * n_kv * n >= SMS                 # still fills the card


def test_plan_reads_shapes_only():
    """The launch's plan and workspace come from shapes: meta tensors
    (which hold no values) give the same plan as real ones, and the
    planner takes no length tensor at all."""
    q = torch.empty((8, 28, 128), dtype=torch.bfloat16, device="meta")
    plan, ws = dsp.prepare(q, 4, 64 * BT, BT, SMS)
    assert plan == dsp.plan_splits(8, 4, 64 * BT, BT, SMS)
    assert ws.device.type == "meta"
    assert ws.numel() == dsp.workspace_floats(plan, 8, 4, 7, 128)
    q1 = torch.empty((2, 4, 64), device="meta")
    plan1, ws1 = dsp.prepare(q1, 2, 16, BT, SMS)
    assert plan1.n_splits == 1 and ws1 is None


# ---------------------------------------------------------------------------
# the replay
# ---------------------------------------------------------------------------
def _round(x, to):
    if to == "bf16":
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
            .bfloat16().float().numpy()
    if to == "f16":
        return np.asarray(x, np.float32).astype(np.float16).astype(np.float32)
    return np.asarray(x, np.float32)


def _gather(k, v, sk, sv, table, layout, b, h, n_tok):
    """Token rows 0 .. n_tok-1 of (row b, kv head h) through the
    kernels' addressing (DecodeLayout), as float32."""
    _, bt, _, blk_rows, row_rows, head_rows, tok_rows = layout
    t = np.arange(n_tok)
    blk = table[b, h, t // bt] if table is not None else t // bt
    r = blk * blk_rows + b * row_rows + h * head_rows + (t % bt) * tok_rows
    kf, vf = k.reshape(-1, k.shape[-1]), v.reshape(-1, v.shape[-1])
    ones = np.ones(n_tok, np.float32)
    return (kf[r].astype(np.float32), vf[r].astype(np.float32),
            sk.reshape(-1)[r] if sk is not None else ones,
            sv.reshape(-1)[r] if sv is not None else ones)


def _walk(qh, K, V, SK, SV, lo, hi, scale, body):
    """One CTA over tokens [lo, hi): its (m, l, acc[G, hd]) state."""
    G, hd = qh.shape
    if body == "f32":             # one state, 32-key chunks
        tiles, fr = [(c, min(c + 32, hi)) for c in range(lo, hi, 32)], None
        groups = [tiles]
    else:                         # 64-key chunks, 16 keys a warp
        fr = "f16" if body == "tc_i8" else "bf16"
        groups = [[(c + 16 * w, min(c + 16 * (w + 1), hi))
                   for c in range(lo, hi, 64) if c + 16 * w < hi]
                  for w in range(4)]
        if body == "tc_i8":       # q scaled by a power of two into f16
            _, e = math.frexp(float(np.abs(qh).max()) or 1.0)
            qs = 2.0 ** (14 - e) if e > 14 else 1.0
            qh, scale = _round(qh * qs, "f16"), scale / qs
    states = []
    for tiles in groups:
        m, l = np.full(G, NEG_INF), np.zeros(G, np.float32)
        acc = np.zeros((G, hd), np.float32)
        for a, b in tiles:
            x = (qh @ K[a:b].T) * (scale * SK[a:b])[None, :]
            m_new = np.maximum(m, x.max(1))
            corr, p = np.exp(m - m_new), np.exp(x - m_new[:, None])
            l = l * corr + p.sum(1)
            p = p * SV[a:b][None, :]
            if fr is not None:
                p = _round(p, fr)
            acc = acc * corr[:, None] + p @ V[a:b]
            m = m_new
        states.append((m, l, acc))
    if len(states) == 1:
        return states[0]
    mx = np.max([s[0] for s in states], 0)
    f = [np.exp(s[0] - mx) for s in states]
    return (mx, sum(s[1] * fi for s, fi in zip(states, f)),
            sum(s[2] * fi[:, None] for s, fi in zip(states, f)))


def replay(q, k, v, sk, sv, table, lens, layout, n_kv, body):
    """The split-KV kernels' output, in numpy.  ``table`` [B, n_kv,
    max_blocks] (or None), ``layout`` as ``paged_attention_int8``'s
    ``paged_layout`` / ``dense_layout``, ``body`` 'f32', 'tc' (bf16
    queries) or 'tc_i8' (bf16 queries over int8)."""
    B, H, hd = q.shape
    G, max_tok = H // n_kv, layout[2]
    plan = dsp.plan_splits(B, n_kv, max_tok,
                           layout[1] if table is not None else None, SMS)
    out = np.zeros((B, H, hd), np.float32)
    for b in range(B):
        n_tok = min(max(int(lens[b]), 0), max_tok)
        n_live = -(-n_tok // plan.split)
        for h in range(n_kv):
            K, V, SK, SV = _gather(k, v, sk, sv, table, layout, b, h, n_tok)
            qh = q[b, h * G:(h + 1) * G].astype(np.float32)
            parts = []
            for s in range(plan.n_splits):
                if s > 0 and s >= n_live:
                    continue          # empty split: exits, writes nothing
                lo, hi = s * plan.split, min(n_tok, (s + 1) * plan.split)
                parts.append(_walk(qh, K, V, SK, SV, lo, max(lo, hi),
                                   1.0 / math.sqrt(hd), body))
            if n_live <= 1:           # written by split 0 directly
                m, l, acc = parts[0]
                o = acc / np.maximum(l, 1e-30)[:, None]
            else:                     # the merge kernel, one online pass
                mx, den = np.full(G, NEG_INF), np.zeros(G, np.float32)
                num = np.zeros((G, hd), np.float32)
                for m, l, acc in parts:
                    m_new = np.maximum(mx, m)
                    c, f = np.exp(mx - m_new), np.exp(m - m_new)
                    den, num = den * c + l * f, num * c[:, None] + acc * f[:, None]
                    mx = m_new
                o = num / np.maximum(den, 1e-30)[:, None]
            out[b, h * G:(h + 1) * G] = o
    return out


# rows: no token, one token, a full table, a row of 2 splits + 22 keys
# (its later splits empty), a row ending inside its first split
LENS = np.array([0, 1, 320, 150, 37], np.int32)
MAX_BLOCKS = 20


def _paged_case(rng, H, n_kv, hd, layers=2):
    group = layers * n_kv
    B = len(LENS)
    table = (4 + np.arange(B * MAX_BLOCKS, dtype=np.int32) * group) \
        .reshape(B, MAX_BLOCKS)
    table[0, :] = -1                               # the padded row
    n_blocks = 4 + B * MAX_BLOCKS * group
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    return q, table, n_blocks


@pytest.mark.parametrize("dt,hd,H,n_kv", [
    ("f32", 64, 4, 2),           # the reduced pool
    ("f32", 128, 14, 2),         # group 7
    ("bf16", 128, 14, 2),        # qwen2-7b's group 7 at hd 128
    ("bf16", 64, 4, 4),          # zamba2-1.2b's group 1 at hd 64
    ("bf16", 96, 4, 4),          # phi-3-vision-4.2b's hd 96, group 1
    ("f32", 96, 8, 2),
    ("bf16", 128, 24, 2),        # command-r-plus-104b's group 12
    ("bf16", 128, 32, 2),        # qwen3-moe-235b-a22b's group 16
    ("f32", 64, 32, 2),
])
def test_decode_replay_matches_plain_and_pallas(dt, hd, H, n_kv):
    rng = np.random.default_rng(0)
    q, table, n_blocks = _paged_case(rng, H, n_kv, hd)
    pk = rng.standard_normal((n_blocks, BT, hd)).astype(np.float32)
    pv = rng.standard_normal((n_blocks, BT, hd)).astype(np.float32)
    if dt == "bf16":
        q, pk, pv = (_round(x, "bf16") for x in (q, pk, pv))
    layer = 1
    phys = resolve_physical_blocks(torch.from_numpy(table), layer, n_kv)
    plan = dsp.plan_splits(len(LENS), n_kv, MAX_BLOCKS * BT, BT, SMS)
    assert plan.n_splits == 5 and plan.split == 64
    got = replay(q, pk, pv, None, None, phys.numpy(), LENS,
                 pi8.paged_layout(BT, MAX_BLOCKS), n_kv,
                 "f32" if dt == "f32" else "tc")
    ref = pa.decode_plain(*map(torch.from_numpy, (q, pk, pv)), phys,
                          torch.from_numpy(LENS)).numpy()
    pal = np.asarray(pallas_decode(*map(jnp.asarray, (q, pk, pv)),
                                   jnp.asarray(phys.numpy()),
                                   jnp.asarray(LENS), interpret=True))
    tol = TOL[dt]
    # the row of no token: 0, as the Pallas kernel (the plain version,
    # the reference's XLA oracle, averages instead)
    assert not got[0].any() and not pal[0].any()
    np.testing.assert_allclose(got[1:], ref[1:], rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pal, rtol=tol, atol=tol)


def _quantize(x):
    s = np.maximum(np.abs(x).max(-1), 1e-8) / np.float32(127.0)
    q = np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


@pytest.mark.parametrize("dt,hd,H,n_kv", [
    ("f32", 64, 4, 2),
    ("bf16", 128, 14, 2),
    ("bf16", 64, 4, 4),
    ("bf16", 96, 4, 4),
    ("f32", 96, 8, 2),
    ("bf16", 128, 24, 2),
    ("bf16", 64, 32, 2),
])
def test_int8_paged_replay_matches_plain_and_pallas(dt, hd, H, n_kv):
    rng = np.random.default_rng(1)
    q, table, n_blocks = _paged_case(rng, H, n_kv, hd)
    k8, sk = _quantize(rng.standard_normal((n_blocks, BT, hd)) * 2)
    v8, sv = _quantize(rng.standard_normal((n_blocks, BT, hd)) * 2)
    if dt == "bf16":
        q = _round(q, "bf16")
    layer = 1
    phys = resolve_physical_blocks(torch.from_numpy(table), layer, n_kv)
    got = replay(q, k8, v8, sk, sv, phys.numpy(), LENS,
                 pi8.paged_layout(BT, MAX_BLOCKS), n_kv,
                 "f32" if dt == "f32" else "tc_i8")
    ref = pi8.paged_int8_plain(*map(torch.from_numpy, (q, k8, v8, sk, sv)),
                               phys, torch.from_numpy(LENS)).numpy()
    pal = np.asarray(pallas_int8(*map(jnp.asarray, (q, k8, v8, sk, sv,
                                                    table, LENS)),
                                 layer, n_kv=n_kv, interpret=True))
    assert not got[0].any() and not ref[0].any()
    tol = TOL[dt] * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=TOL[dt], atol=tol)
    np.testing.assert_allclose(got, pal, rtol=TOL[dt], atol=tol)


# the W8/KV8 step's S 544 (8.5 splits of 64) and an S no split divides
@pytest.mark.parametrize("dt,S", [("f32", 544), ("bf16", 544), ("bf16", 201)])
def test_int8_dense_replay_matches_plain(dt, S):
    rng = np.random.default_rng(2)
    B, H, KV, hd = 5, 14, 2, 128
    ck, sk = _quantize(rng.standard_normal((B, S, KV, hd)) * 2)
    cv, sv = _quantize(rng.standard_normal((B, S, KV, hd)) * 2)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    if dt == "bf16":
        q = _round(q, "bf16")
    lens = np.array([0, 1, S, S - 37, 65], np.int32)
    plan = dsp.plan_splits(B, KV, S, None, SMS)
    assert S % plan.split and plan.n_splits >= 4
    got = replay(q, ck, cv, sk, sv, None, lens, pi8.dense_layout(S, KV), KV,
                 "f32" if dt == "f32" else "tc_i8")
    ref = pi8.dense_int8_plain(*map(torch.from_numpy, (q, ck, cv, sk, sv,
                                                       lens))).numpy()
    assert not got[0].any() and not ref[0].any()
    np.testing.assert_allclose(got, ref, rtol=TOL[dt],
                               atol=TOL[dt] * np.abs(ref).max())


def test_empty_splits_merge_to_nothing():
    """An empty split's state (m = NEG_INF, l = 0, acc = 0), were it
    written, would not change the merge: the kernels skip it."""
    rng = np.random.default_rng(3)
    G, hd = 3, 8
    parts = [(rng.standard_normal(G).astype(np.float32),
              rng.random(G).astype(np.float32) + 0.5,
              rng.standard_normal((G, hd)).astype(np.float32))
             for _ in range(3)]
    empty = (np.full(G, NEG_INF), np.zeros(G, np.float32),
             np.zeros((G, hd), np.float32))

    def merge(ps):
        mx = np.max([p[0] for p in ps], 0)
        f = [np.exp(p[0] - mx) for p in ps]
        return (sum(p[2] * fi[:, None] for p, fi in zip(ps, f))
                / sum(p[1] * fi for p, fi in zip(ps, f))[:, None])
    np.testing.assert_array_equal(merge(parts), merge(parts + [empty] * 2))


# ---------------------------------------------------------------------------
# layouts: the ring's swizzle, the m16 tile, the workspace, shared memory
# ---------------------------------------------------------------------------
CSRC = Path(dsp.__file__).resolve().parent / "csrc"


def swizzle(units, u, r):
    """decode_splitkv.cuh's ``swizzle<UNITS>(u, r)``: u's low log2(G)
    bits XOR (r / (8 / G)) % G, G = gcd(UNITS, 8)."""
    g = math.gcd(units, 8)
    return u ^ ((r // (8 // g)) & (g - 1))


# 16-byte units of a ring row: int8 hd 64 (4), int8 hd 96 (6), bf16 hd 64
# and int8 hd 128 (8), bf16 hd 96 (12), bf16 hd 128 and f32 hd 64 (16),
# f32 hd 96 (24), f32 hd 128 (32)
@pytest.mark.parametrize("units", [4, 6, 8, 12, 16, 24, 32])
def test_ring_swizzle_permutes_units_and_spreads_bank_groups(units):
    rows = 64
    for r in range(rows):
        assert sorted(swizzle(units, u, r) for u in range(units)) == \
            list(range(units))
    # a row of `units` 16-byte units starts at bank group (r*units) % 8;
    # 8 lanes reading unit u of 8 consecutive rows must hit 8 groups
    for u in range(units):
        for r0 in range(rows - 7):
            groups = {(r * units + swizzle(units, u, r)) % 8
                      for r in range(r0, r0 + 8)}
            assert len(groups) == 8, (units, u, r0)


def test_ring_swizzle_keeps_the_old_rows_layout():
    """At the row widths of head dims 64 and 128 the swizzle is the one
    the kernels had (u ^ r % 8 for 8+ units, u ^ (r / 2) % 4 for 4)."""
    for units in (8, 16, 32):
        assert all(swizzle(units, u, r) == u ^ (r & 7)
                   for u in range(units) for r in range(64))
    assert all(swizzle(4, u, r) == u ^ ((r >> 1) & 3)
               for u in range(4) for r in range(64))


def _mma(a_frags, b_frags):
    """m16n8k16 from per-lane fragments: A [16, 16] from a_frags[lane]
    (a0: row n, k 2c..2c+1; a1: row n+8; a2: row n, k 2c+8..; a3: row
    n+8, k 2c+8..), B [16, 8] from b_frags[lane] (b0: k 2c..2c+1, col
    n; b1: k 2c+8..), returns D [16, 8] as per-lane (d0, d1: row n, cols
    2c, 2c+1; d2, d3: row n+8)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        n, c = lane // 4, lane % 4
        a = a_frags[lane]
        A[n, 2 * c:2 * c + 2], A[n + 8, 2 * c:2 * c + 2] = a[0], a[1]
        A[n, 2 * c + 8:2 * c + 10], A[n + 8, 2 * c + 8:2 * c + 10] = a[2], a[3]
        b = b_frags[lane]
        B[2 * c:2 * c + 2, n], B[2 * c + 8:2 * c + 10, n] = b[0], b[1]
    D = A @ B
    return [(D[n, 2 * c], D[n, 2 * c + 1], D[n + 8, 2 * c], D[n + 8, 2 * c + 1])
            for n, c in ((lane // 4, lane % 4) for lane in range(32))]


@pytest.mark.parametrize("G", [1, 7, 8, 9, 12, 16])
@pytest.mark.parametrize("hd", [64, 96])
def test_tc_tile_holds_each_head_in_its_row(G, hd):
    """One warp's 16-key tile of the bf16 body at fragment level (f32
    arithmetic): Q's A fragments (head n + 8 hr in tile row n + 8 hr,
    zero past the group and, NR 1, in rows 8-15), S by m16n8k16 per
    k-step, each lane's softmax state per head row it holds (quad
    reduced), P as the A fragment of P V, and the merge's writes
    red[g][o_dim] = o[j][2 hr + e]: every head's row equals softmax(q
    K^T) V, at groups of up to 8 (NR 1) and of 9-16 (NR 2)."""
    rng = np.random.default_rng(G + hd)
    q = rng.standard_normal((G, hd))
    K, V = rng.standard_normal((16, hd)), rng.standard_normal((16, hd))
    NR = 2 if G > 8 else 1
    NT = hd // 8
    S = [[[0.0] * 4 for _ in range(32)] for _ in range(2)]   # [key tile][lane]
    for st in range(hd // 16):
        qa = []
        for lane in range(32):
            n, c = lane // 4, lane % 4
            fr = []
            for half in (0, 1):          # k-slots 2c.. (half 0), 2c+8..
                for hr in (0, 1):
                    g = n + 8 * hr
                    live = hr < NR and g < G
                    d0 = st * 16 + 2 * c + 8 * half
                    fr.append(q[g, d0:d0 + 2] if live else np.zeros(2))
            qa.append((fr[0], fr[1], fr[2], fr[3]))
        for j in range(2):               # keys 8j .. 8j + 7
            kb = [(K[8 * j + lane // 4, st * 16 + 2 * (lane % 4):][:2],
                   K[8 * j + lane // 4, st * 16 + 2 * (lane % 4) + 8:][:2])
                  for lane in range(32)]
            d = _mma(qa, kb)
            for lane in range(32):
                S[j][lane] = [S[j][lane][e] + d[lane][e] for e in range(4)]
    scale = 1 / math.sqrt(hd)
    red = np.full((16, hd), np.nan)
    P = [[None] * 32 for _ in range(NR)]
    L = np.zeros((32, NR))
    for lane in range(32):
        for hr in range(NR):
            P[hr][lane] = np.array([[S[j][lane][2 * hr + e] * scale
                                     for e in (0, 1)] for j in (0, 1)])
    for hr in range(NR):                  # quad max and sum, one chunk
        mx = [max(P[hr][i].max() for i in range(lane // 4 * 4,
                                                 lane // 4 * 4 + 4))
              for lane in range(32)]
        for lane in range(32):
            P[hr][lane] = np.exp(P[hr][lane] - mx[lane])
        for lane in range(32):
            quad = range(lane // 4 * 4, lane // 4 * 4 + 4)
            L[lane, hr] = sum(P[hr][i].sum() for i in quad)
    pa = [(P[0][lane][0], P[NR - 1][lane][0] if NR > 1 else np.zeros(2),
           P[0][lane][1], P[NR - 1][lane][1] if NR > 1 else np.zeros(2))
          for lane in range(32)]
    O = [[None] * NT for _ in range(32)]
    for j in range(NT):                  # output dims 8j .. 8j + 7
        vb = [(V[2 * (lane % 4):2 * (lane % 4) + 2, 8 * j + lane // 4],
               V[2 * (lane % 4) + 8:2 * (lane % 4) + 10, 8 * j + lane // 4])
              for lane in range(32)]
        d = _mma(pa, vb)
        for lane in range(32):
            O[lane][j] = d[lane]
    for lane in range(32):
        n, c = lane // 4, lane % 4
        for hr in range(NR):
            g = n + 8 * hr
            if g < G:
                for j in range(NT):
                    red[g, 8 * j + 2 * c] = O[lane][j][2 * hr] / L[lane, hr]
                    red[g, 8 * j + 2 * c + 1] = O[lane][j][2 * hr + 1] / \
                        L[lane, hr]
    s = q @ K.T * scale
    p = np.exp(s - s.max(1, keepdims=True))
    want = (p / p.sum(1, keepdims=True)) @ V
    np.testing.assert_allclose(red[:G], want, rtol=1e-12, atol=1e-12)
    assert np.isnan(red[G:]).all()       # no lane writes a head past G


def _ws_slots(B, n_kv, n_splits, G, hd):
    """Every workspace float the kernels write, by (what, bh, split, g,
    index): decode_splitkv.cuh's (m, l) at ((bh n_splits + s)
    SK_MAX_GROUP + g) 2 and acc at ml_floats + ((bh n_splits + s) G + g)
    hd + d."""
    ml_floats = B * n_kv * n_splits * dsp.MAX_GROUP * 2
    seen = {}
    for bh in range(B * n_kv):
        for s_ in range(n_splits):
            for g in range(G):
                base = ((bh * n_splits + s_) * dsp.MAX_GROUP + g) * 2
                seen[base] = seen.get(base, 0) + 1
                seen[base + 1] = seen.get(base + 1, 0) + 1
                a0 = ml_floats + ((bh * n_splits + s_) * G + g) * hd
                for d in range(hd):
                    seen[a0 + d] = seen.get(a0 + d, 0) + 1
    return seen


@pytest.mark.parametrize("G,hd", [(16, 96), (12, 128), (7, 64), (1, 96)])
def test_workspace_slots_are_disjoint_and_in_bounds(G, hd):
    B, n_kv = 3, 2
    plan = dsp.SplitPlan(64, 5)
    seen = _ws_slots(B, n_kv, plan.n_splits, G, hd)
    assert max(seen.values()) == 1                   # no slot written twice
    assert max(seen) < dsp.workspace_floats(plan, B, n_kv, G, hd)
    assert dsp.MAX_GROUP == 16


def sk_smem(kv, hd, chunk):
    """decode_splitkv.cuh's ``SkSmem<KV, HD, CHUNK>``: (BYTES, RESIDENT)
    for K/V elements of ``kv`` ('f32', 'bf16', 'int8')."""
    esize = {"f32": 4, "bf16": 2, "int8": 1}[kv]
    scaled, mg, ids = kv == "int8", dsp.MAX_GROUP, dsp.MAX_IDS
    cuda_cores = chunk == 32
    row = hd * esize
    kv_bytes = chunk * row
    stage = 2 * kv_bytes + (2 * chunk * 4 if scaled else 0)
    stages = min(max(65536 // stage, 2), 4)
    q_off = max(stages * stage, 4 * mg * hd * 4)
    spart = q_off + mg * hd * 4
    p_off = spart + (4 * mg * chunk * 4 if cuda_cores else 0)
    corr = p_off + (mg * chunk * 4 if cuda_cores else 0)
    m_off = corr + (mg * 4 if cuda_cores else 0)
    rows_off = m_off + 2 * 4 * mg * 4
    nbytes = rows_off + ids * 8
    return nbytes, min(max(228 * 1024 // (nbytes + 1024), 1), 3)


def test_shared_memory_layout_fits_three_ctas_an_sm():
    """The tensor-core body's launch bound is 3 CTAs an SM at every head
    dim, bf16 and int8 K/V (the float32 body's score buffers are not in
    its layout); the bytes are what the built kernels report on an H100
    (``decode_splits.occupancy``, checked on the card by
    ``tests/test_torch_cuda.py``)."""
    for kv in ("bf16", "int8"):
        for hd in (64, 96, 128):
            assert sk_smem(kv, hd, 64)[1] == 3, (kv, hd)
    assert [sk_smem("bf16", hd, 64)[0] for hd in (64, 96, 128)] == \
        [72208, 57872, 76304]
    assert [sk_smem("f32", hd, 32)[0] for hd in (64, 96, 128)] == \
        [82512, 68176, 86608]


def _cuh_int(name):
    text = (CSRC / "decode_splitkv.cuh").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


def test_python_mirrors_equal_the_source_constants():
    assert dsp.MAX_GROUP == _cuh_int("SK_MAX_GROUP") == 16
    assert dsp.ALIGN == _cuh_int("SK_SPLIT_ALIGN")
    assert dsp.MAX_IDS == _cuh_int("SK_MAX_IDS")
    assert pa.MAX_GROUP == pi8.MAX_GROUP == dsp.MAX_GROUP
    # the head dims each entry point dispatches, in both dtypes
    from repro_torch.kernels import flash_prefill as fp
    for src, dims in (("paged_decode.cu", pa.HEAD_DIMS),
                      ("paged_decode_int8.cu", pi8.HEAD_DIMS),
                      ("paged_prefill.cu", fp.HEAD_DIMS),
                      ("flash_prefill.cu", fp.HEAD_DIMS)):
        text = (CSRC / src).read_text()
        body = text[text.index('extern "C" int repro_'):]
        for dt in ("F32", "BF16"):
            got = sorted({int(x) for x in re.findall(
                rf"dtype == {dt} && hd == (\d+)\)\n\s+err = launch",
                body)})
            assert tuple(got) == dims == (64, 96, 128), (src, dt, got)
