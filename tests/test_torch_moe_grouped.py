"""The dropless MoE FFN's grouped-expert SwiGLU (``repro_torch.kernels
.moe_grouped``, kernel 6) on the CPU.

* ``moe_ffn_dropless`` (route, ``sort_slots``, the plain version) against
  the port's grouped loop as it was before the kernel (its code kept
  below: the per-expert counts read on the host) bit for bit, and
  against the JAX package's ``moe_ffn_dropless`` (per-token gathered
  weights) within 2e-5 in float32 (two libraries' matmuls) and 2e-2 of
  the largest |out| in bfloat16, on the same seeded numpy inputs and the
  reference's weights: 4, 32 and 128 experts, top 1, 2 and 8, 1, 7 and
  64 tokens, one expert taking every slot and experts left empty.
* ``sort_slots`` against a numpy stable counting sort, and on ``meta``
  tensors (no data, so no host read can hide in it).
* A numpy replay of the kernel's schedule (``csrc/moe_grouped.cu``) at
  each tile plan (float32's 16-row tiles, bf16's 64- and 128-row ones):
  the worst-case grid (``m_tiles`` M tiles × the launch's N tiles), each
  CTA's (expert, M tile) found from ``offsets`` by the block scan, CTAs
  with no tile exiting, the gate/up rows written at their sorted
  position and the down rows at their slot, each exactly once, against
  the plain version (float64).  The grid's bound on adversarial counts
  at each tile height, and the plan the host picks at every shape
  ``chip_smoke.py`` times.
* A numpy replay of the bf16 kernel's shared-memory layouts: the
  gathered A stage (chunk c of row r at c ^ (r % 8)) and the TMA boxes
  (the weights' 3-D map per expert, act's 2-D map), stage by stage with
  the ragged K and N edges zero-filled and the rows past an expert NaN,
  read back at the addresses the K-major and transposed descriptors
  give, through both launches, against the plain version.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import config as jconfig
from repro.models import moe as JM
from repro_torch import config as tconfig
from repro_torch.kernels import moe_grouped as MG
from repro_torch.models import moe as TM
from repro_torch.models.transformer import params_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)
TOL = {np.float32: 2e-5, jnp.bfloat16: 2e-2}
D, FE = 64, 32           # widths of the FFN tests


def _old_dropless(x, p, li, cfg):
    """The port's dropless FFN before kernel 6: a stable argsort of the
    expert index, the per-expert counts read on the host, a loop over
    the experts."""
    mc = cfg.moe
    b, s, d = x.shape
    T, k = b * s, mc.top_k
    xt = x.reshape(T, d)
    gates, idx, aux = TM.route(xt, p["router"][li], mc)
    wg, wu, wd = p["w_gate"][li], p["w_up"][li], p["w_down"][li]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=mc.n_experts).tolist()
    xs = xt[order // k]
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            dt = torch.promote_types(xs.dtype, wg.dtype)
            h = F.silu(xs[start:start + n].to(dt) @ wg[e].to(dt)) \
                * (xs[start:start + n].to(dt) @ wu[e].to(dt))
            outs.append(h @ wd[e].to(dt))
            start += n
    y_sorted = torch.cat(outs)
    y = torch.empty_like(y_sorted)
    y[order] = y_sorted
    out = (y.reshape(T, k, d) * gates[..., None].to(y.dtype)).sum(dim=1)
    return out.reshape(b, s, d), aux


def _cfgs(E, k):
    kw = dict(name="m", family="moe", n_layers=2, d_model=D, n_heads=4,
              n_kv_heads=2, d_ff=FE, vocab_size=64)
    return (jconfig.ModelConfig(moe=jconfig.MoEConfig(E, k, FE), **kw),
            tconfig.ModelConfig(moe=tconfig.MoEConfig(E, k, FE), **kw))


def _params(jc, seed, dtype, one_expert=False):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jc, jc.n_layers, dtype)
    if one_expert:        # with x > 0, every token's first expert is 0
        jp["router"] = jp["router"].at[:, :, 0].add(100.0)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_to_torch(jp, "cpu")


# (experts, top-k, tokens, one expert takes every slot): every expert
# count (4, 32, 128), top-k (1, 2, 8) and token count (1, 7, 64) is
# met; with 128 experts and at most 56 slots most experts stay empty
FFN_CASES = [(4, 2, 7, False), (4, 1, 64, False), (4, 1, 64, True),
             (32, 8, 64, False), (32, 2, 1, False), (32, 1, 7, True),
             (128, 8, 1, False), (128, 8, 7, False), (128, 1, 64, True)]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("E,k,T,one", FFN_CASES)
def test_dropless_ffn_matches_old_loop_and_reference(E, k, T, one, dtype):
    jc, tc = _cfgs(E, k)
    jp, tp = _params(jc, E + T, jnp.float32 if dtype == np.float32
                     else jnp.bfloat16, one)
    x = np.random.default_rng(T + k).standard_normal((1, T, D)).astype(
        np.float32)
    if one:
        x = np.abs(x)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16)
    li = 1
    got, aux = TM.moe_ffn_dropless(xt, tp, li, tc)
    old, old_aux = _old_dropless(xt, tp, li, tc)
    assert torch.equal(got, old) and torch.equal(aux, old_aux)
    if one:
        _, idx, _ = TM.route(xt.reshape(T, D), tp["router"][li], tc.moe)
        assert (idx[:, 0] == 0).all()
    jo, ja = JM.moe_ffn_dropless(xj, jp, li, jc)
    ref = np.asarray(jo.astype(jnp.float32))
    out = got.float().numpy()
    tol = TOL[dtype] * (1 if dtype == np.float32 else np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=tol)
    np.testing.assert_allclose(float(aux), float(ja), rtol=2e-5, atol=2e-5)


def _counting_sort(idx: np.ndarray, E: int):
    """Stable counting sort of the flat slots by expert (numpy)."""
    flat = idx.reshape(-1)
    counts = np.zeros(E, np.int64)
    for e in flat:
        counts[e] += 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    at = offsets[:-1].copy()
    order = np.empty_like(flat)
    for s, e in enumerate(flat):
        order[at[e]] = s
        at[e] += 1
    return order, offsets


def _routings():
    """(name, expert indices [T, k], E): top-k routings and the edges."""
    rng = np.random.default_rng(0)
    out = []
    for E, k, T in ((4, 2, 7), (32, 8, 64), (128, 8, 1), (128, 8, 64),
                    (128, 1, 64), (5, 3, 17)):
        idx = np.argsort(-rng.standard_normal((T, E)), axis=1)[:, :k]
        out.append((f"top{k} of {E}, {T} tokens", idx, E))
    out.append(("every slot on one expert", np.full((64, 8), 7), 32))
    out.append(("one token", np.array([[3, 0, 31, 9, 12, 5, 30, 2]]), 32))
    out.append(("every slot on the last expert, 128",
                np.full((9, 8), 127), 128))
    return out


@pytest.mark.parametrize("name,idx,E", _routings(),
                         ids=[r[0] for r in _routings()])
def test_sort_slots_is_a_stable_counting_sort(name, idx, E):
    order, offsets = MG.sort_slots(torch.from_numpy(idx), E)
    want_order, want_offsets = _counting_sort(idx, E)
    assert order.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)


def test_sort_slots_runs_on_meta():
    """On ``meta`` tensors (shapes, no data) the routing prep runs to
    the end: none of its ops reads a value on the host."""
    idx = torch.empty((64, 8), dtype=torch.int64, device="meta")
    order, offsets = MG.sort_slots(idx, 128)
    assert order.device.type == offsets.device.type == "meta"
    assert order.shape == (512,) and offsets.shape == (129,)
    assert order.dtype == offsets.dtype == torch.int32
    # the whole FFN's routing half too: route, then sort
    x = torch.empty((1, 64, D), device="meta")
    gates, idx, _ = TM.route(x.reshape(64, D),
                             torch.empty((D, 128), device="meta"),
                             tconfig.MoEConfig(128, 8, FE))
    order, offsets = MG.sort_slots(idx, 128)
    assert offsets.shape == (129,) and gates.shape == (64, 8)


def _silu(v):
    return v / (1.0 + np.exp(-v))


def replay_schedule(x, order, offsets, wg, wu, wd, k, plan):
    """The kernel's two launches replayed in numpy (float64) at tile
    plan ``plan`` = (BM, gate/up BN, down BN): every CTA of the fixed
    grid (``m_tiles`` M tiles × the launch's N tiles, CTA b on N tile
    b % n_tiles of M tile b // n_tiles), its tile found from ``offsets``
    alone.  Returns (y [n, d], CTAs that found a tile per launch, grid
    CTAs per launch); asserts every act and y element is written exactly
    once."""
    n, (E, d, f) = len(order), wg.shape
    BM = plan[0]
    grid_m = MG.m_tiles(n, E, BM)
    act = np.zeros((n, f))
    y = np.zeros((n, d))
    writes = {"act": np.zeros((n, f), int), "y": np.zeros((n, d), int)}
    busy, grid = {}, {}
    # the block scan: thread e counts expert e's tiles
    counts = [-(-(offsets[e + 1] - offsets[e]) // BM) for e in range(E)]
    starts = np.concatenate([[0], np.cumsum(counts)])
    for launch, N, BN in (("act", f, plan[1]), ("y", d, plan[2])):
        n_tiles = -(-N // BN)
        busy[launch], grid[launch] = 0, grid_m * n_tiles
        for b in range(grid[launch]):
            tm, tn = divmod(b, n_tiles)
            hit = [e for e in range(E)
                   if starts[e] <= tm < starts[e] + counts[e]]
            if not hit:
                continue                          # a CTA with no tile
            assert len(hit) == 1
            e = hit[0]
            busy[launch] += 1
            row0 = offsets[e] + (tm - starts[e]) * BM
            rows = [i for i in range(row0, row0 + BM) if i < offsets[e + 1]]
            cols = slice(tn * BN, min((tn + 1) * BN, N))
            for i in rows:
                if launch == "act":
                    xr = x[order[i] // k]
                    act[i, cols] = (_silu(xr @ wg[e][:, cols])
                                    * (xr @ wu[e][:, cols]))
                    writes["act"][i, cols] += 1
                else:
                    y[order[i], cols] = act[i] @ wd[e][:, cols]
                    writes["y"][order[i], cols] += 1
    assert (writes["act"] == 1).all() and (writes["y"] == 1).all()
    return y, busy, grid


# tile plans (BM, gate/up BN, down BN): float32's, and bf16's 64- and
# 128-row tiles with each N tile width in each launch
PLANS = [MG.F32_PLAN, (64, 64, 128), (128, 128, 64)]


def _expert_weights(E, d, f, seed):
    rng = np.random.default_rng(seed)
    wg, wu = (rng.standard_normal((E, d, f)) / np.sqrt(d) for _ in range(2))
    wd = rng.standard_normal((E, f, d)) / np.sqrt(f)
    return rng, wg, wu, wd


def _plain64(x, order, offsets, wg, wu, wd, k):
    return MG.grouped_swiglu_plain(
        torch.from_numpy(x), order, offsets,
        *(torch.from_numpy(w) for w in (wg, wu, wd)), k).numpy()


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "x".join(map(str, p)))
@pytest.mark.parametrize("name,idx,E", _routings(),
                         ids=[r[0] for r in _routings()])
def test_tile_schedule_replay_matches_plain(name, idx, E, plan):
    T, k = idx.shape
    d, f = 72, 80          # a ragged N tile in both launches
    rng, wg, wu, wd = _expert_weights(E, d, f, E + T)
    x = rng.standard_normal((T, d))
    order, offsets = MG.sort_slots(torch.from_numpy(idx), E)
    o, off = order.numpy(), offsets.numpy()
    y, busy, grid = replay_schedule(x, o, off, wg, wu, wd, k, plan)
    np.testing.assert_allclose(_plain64(x, order, offsets, wg, wu, wd, k),
                               y, rtol=1e-12, atol=1e-12)
    tiles = sum(-(-(off[e + 1] - off[e]) // plan[0]) for e in range(E))
    assert busy == {"act": tiles * -(-f // plan[1]),
                    "y": tiles * -(-d // plan[2])}
    assert all(busy[n] <= grid[n] for n in grid)


@pytest.mark.parametrize("bm", [16, 64, 128])
def test_grid_bounds_every_routing(bm):
    """Σₑ ⌈nₑ / BM⌉ ≤ ``m_tiles(n, E, BM)`` for any counts summing to n,
    at each M-tile height a plan takes, the bound met with equality
    where every non-empty expert holds one slot past a multiple of BM."""
    rng = np.random.default_rng(1)
    for E in (1, 4, 32, 128):
        for n in (1, 7, 8, 32, 64, 512, 2048, 16384):
            m = MG.m_tiles(n, E, bm)
            for _ in range(20):
                counts = rng.multinomial(n, rng.dirichlet(np.ones(E) * 0.3))
                assert sum(-(-c // bm) for c in counts) <= m
            # the worst case: as many experts as can hold BM·j + 1 slots
            worst = np.zeros(E, int)
            for i in range(n):
                worst[i % E] += 1
            assert sum(-(-c // bm) for c in worst) <= m
        for j in range(3):     # every expert holding BM·j + 1 slots
            n = E * (bm * j + 1)
            assert MG.m_tiles(n, E, bm) == E * (j + 1)
    want = {16: (32, 62, 9), 64: (32, 39, 9), 128: (32, 35, 9)}[bm]
    assert (MG.m_tiles(32, 128, bm), MG.m_tiles(512, 32, bm),
            MG.m_tiles(bm * 9, 1, bm)) == want


# the tile plan at every shape chip_smoke.py holds kernel 6 to: a pure
# function of (slots, experts, d, f, dtype)
CHIP_PLANS = {
    "granite-moe decode bf16": (64, 64, 128),
    "granite-moe chunk bf16": (64, 64, 128),
    "qwen3-moe decode bf16": (64, 128, 128),
    "qwen3-moe chunk bf16": (64, 128, 128),
    "granite-moe 4 x 64 chunk bf16": (128, 64, 128),
    "qwen3-moe 4 x 512 whole-prompt prefill bf16": (128, 128, 128),
    "qwen3-moe 1 x 512 whole-prompt prefill bf16": (64, 128, 128),
    "bf16, d 72 and f 40 (ragged tile edges)": (64, 64, 64),
    "granite-moe bf16, every slot on one expert": (64, 64, 128),
    "granite-moe bf16, one token": (64, 64, 64),
    "qwen3-moe bf16, one token": (64, 64, 64),
}


@pytest.mark.parametrize("shape", chip_smoke.MOE_SHAPES,
                         ids=[s["label"] for s in chip_smoke.MOE_SHAPES])
def test_plan_at_every_chip_shape(shape):
    n = shape["T"] * shape["k"]
    dtype = getattr(torch, shape["dtype"])
    args = (n, shape["E"], shape["d"], shape["f"], dtype)
    got = MG.plan(*args)
    assert got == CHIP_PLANS.get(shape["label"], MG.F32_PLAN)
    assert got == MG.plan(*args)                       # no state
    if dtype == torch.float32:
        assert got == MG.F32_PLAN
    else:
        assert got[0] in (64, 128) and set(got[1:]) <= {64, 128}


def test_plan_row_threshold():
    """128-row M tiles where a non-empty expert averages more than 48
    rows: granite-moe at 192 and 193 tokens (top 8 of 32) fall on either
    side; 128-column N tiles only where two waves of CTAs remain."""
    bf = torch.bfloat16
    assert MG.plan(192 * 8, 32, 1536, 512, bf)[0] == 64
    assert MG.plan(193 * 8, 32, 1536, 512, bf)[0] == 128
    assert MG.plan(8, 32, 1536, 512, bf) == (64, 64, 64)     # 8 CTAs a tile
    assert MG.plan(4096, 8, 4096, 64, bf)[1] == 64           # f of one atom


# ---------------------------------------------------------------------------
# the bf16 kernel's shared-memory layouts, replayed in numpy: what the
# gate/up gather and the TMA boxes write, read back at the addresses the
# wgmma descriptors give, through the 128-byte swizzle
# ---------------------------------------------------------------------------
BK = 64                  # a stage's depth (WG_BK)


def sw128(a):
    """The 128-byte swizzle of a byte offset in a 1024-aligned atom: the
    16-byte chunk index (bits 4-6) xor the row in its 8-row group (bits
    7-9)."""
    return a ^ (((a >> 7) & 7) << 4)


def gather_stage(x, toks, k0, bm):
    """The gate/up A stage as the producer's cp.async writes it: chunk c
    of row r (x[toks[r], k0 + 8c : +8], zeros past d) at byte r·128 +
    ((c ^ (r % 8))·16).  Rows past the expert's (toks shorter than bm)
    are never written: NaN here."""
    d = x.shape[1]
    buf = np.full(bm * BK, np.nan)
    for r, t in enumerate(toks):
        for c in range(8):
            k = k0 + 8 * c
            v = x[t, k:k + 8] if k < d else np.zeros(8)
            at = (r * 128 + ((c ^ (r % 8)) * 16)) // 2
            buf[at:at + 8] = v
    return buf


def tma_box(a, c0, c1, c2=None, rows=BK):
    """A box of a 128-byte-swizzled map as TMA lands it: ``rows`` rows
    of 64 elements from (c0 inner, c1 rows[, c2]) on, zero past the
    tensor; element (r, c) at byte sw128(r·128 + 2c)."""
    src = a if c2 is None else a[c2]
    R, C = src.shape
    r, c = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    gr, gc = c1 + r, c0 + c
    ok = (gr < R) & (gc < C)
    vals = np.where(ok, src[np.minimum(gr, R - 1), np.minimum(gc, C - 1)], 0)
    buf = np.zeros(rows * 64)
    buf[sw128(r * 128 + c * 2) // 2] = vals
    return buf


def read_a(buf, g, kk):
    """A[64 × 16] of warpgroup g at k-step kk through the K-major
    descriptor (start g·8192 + kk·32 bytes, rows 128 bytes apart, 8-row
    groups SBO 1024 apart)."""
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    a = g * 8192 + kk * 32 + (m // 8) * 1024 + (m % 8) * 128 + k * 2
    return buf[sw128(a) // 2]


def read_b(atoms, kk, bn):
    """B[16 × bn] at k-step kk through the transposed (N-major)
    descriptor: start kk·2048 bytes, 64-column atoms LBO 8192 apart,
    8-row K groups SBO 1024 apart."""
    k, n = np.meshgrid(np.arange(16), np.arange(bn), indexing="ij")
    a = (kk * 2048 + (n // 64) * 8192 + (k // 8) * 1024 + (k % 8) * 128
         + (n % 64) * 2)
    return atoms[sw128(a) // 2]


def replay_wgmma(x, order, offsets, wg, wu, wd, k, plan):
    """Both bf16 launches through those layouts (float64): for each busy
    CTA, stage by stage, the weight atoms of the 3-D map's boxes at
    (n0 + 64a, k0, e), the A stage (gate/up: gathered; down: act's 2-D
    box at (k0, row0), the next expert's rows included), every k-step's
    products through the descriptors, and the epilogue's stores.
    Returns y; asserts every stored value is finite (padding rows hold
    NaN) and every element written once."""
    n, (E, d, f) = len(order), wg.shape
    bm, bns = plan[0], {"act": plan[1], "y": plan[2]}
    act = np.full((n, f), np.nan)
    y = np.full((n, d), np.nan)
    for launch, K, N, ws in (("act", d, f, (wg, wu)), ("y", f, d, (wd,))):
        bn = bns[launch]
        for e in range(E):
            lo, hi = offsets[e], offsets[e + 1]
            for row0 in range(lo, hi, bm):
                for n0 in range(0, N, bn):
                    acc = [np.zeros((bm, bn)) for _ in ws]
                    for k0 in range(0, K, BK):
                        atoms = [np.concatenate([tma_box(w, n0 + 64 * a, k0,
                                                         e)
                                                 for a in range(bn // 64)])
                                 for w in ws]
                        if launch == "act":
                            a_buf = gather_stage(
                                x, order[row0:min(row0 + bm, hi)] // k, k0,
                                bm)
                        else:
                            a_buf = tma_box(act, k0, row0, rows=bm)
                        for g in range(bm // 64):
                            for kk in range(BK // 16):
                                av = read_a(a_buf, g, kk)
                                for m, at in enumerate(atoms):
                                    acc[m][64 * g:64 * g + 64] += (
                                        av @ read_b(at, kk, bn))
                    rows = np.arange(row0, min(row0 + bm, hi))
                    cols = np.arange(n0, min(n0 + bn, N))
                    got = acc[0][:len(rows), :len(cols)]
                    if launch == "act":
                        got = _silu(got) * acc[1][:len(rows), :len(cols)]
                        dst = rows
                    else:
                        dst = order[rows]
                    out = act if launch == "act" else y
                    assert np.isfinite(got).all()
                    assert np.isnan(out[np.ix_(dst, cols)]).all()
                    out[np.ix_(dst, cols)] = got
    assert np.isfinite(act).all() and np.isfinite(y).all()
    return y


@pytest.mark.parametrize("plan", [(64, 64, 128), (128, 128, 64)],
                         ids=lambda p: "x".join(map(str, p)))
@pytest.mark.parametrize("E,k,T,d,f,skew", [
    (8, 3, 7, 72, 40, False),         # d, f of one atom, both ragged
    (4, 2, 40, 136, 200, True),       # ragged K past a stage, 3 N atoms
    (5, 1, 150, 64, 64, True),        # an expert over two 128-row tiles
])
def test_wgmma_layouts_replay_matches_plain(E, k, T, d, f, skew, plan):
    rng, wg, wu, wd = _expert_weights(E, d, f, T + d)
    x = rng.standard_normal((T, d))
    logits = rng.standard_normal((T, E)) + (3.0 * np.arange(E) / E
                                           if skew else 0.0)
    idx = np.argsort(-logits, axis=1)[:, :k]
    order, offsets = MG.sort_slots(torch.from_numpy(idx), E)
    y = replay_wgmma(x, order.numpy(), offsets.numpy(), wg, wu, wd, k, plan)
    np.testing.assert_allclose(_plain64(x, order, offsets, wg, wu, wd, k),
                               y, rtol=1e-10, atol=1e-10)


def test_swizzle_layouts_agree():
    """The gather's chunk placement is TMA's swizzle of the same rows,
    and both descriptors read back every element of a stage exactly once
    (a bijection on the stage's bytes)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 64))
    toks = rng.permutation(300)[:128]
    np.testing.assert_array_equal(gather_stage(x, toks, 0, 128),
                                  tma_box(x[toks], 0, 0, rows=128))
    seen = np.zeros(128 * 64, int)
    for g in range(2):
        for kk in range(4):
            m, kc = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
            a = g * 8192 + kk * 32 + (m // 8) * 1024 + (m % 8) * 128 + kc * 2
            np.add.at(seen, sw128(a) // 2, 1)
    assert (seen == 1).all()
    seen = np.zeros(2 * 64 * 64, int)
    for kk in range(4):
        kc, nc = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
        a = (kk * 2048 + (nc // 64) * 8192 + (kc // 8) * 1024
             + (kc % 8) * 128 + (nc % 64) * 2)
        np.add.at(seen, sw128(a) // 2, 1)
    assert (seen == 1).all()
