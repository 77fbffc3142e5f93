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
much longer than one split are covered.  Tolerance: float32 2e-5;
bf16 2e-2 (the replay rounds P to bf16, the references do not).
"""
import math

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
