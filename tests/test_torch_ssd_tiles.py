"""The tensor-core SSD scan's schedule, replayed in numpy on the CPU.

The bf16 body of ``csrc/ssd_scan.cu`` (``ssd_scan_tc_kernel``) runs only
on the card.  This file replays what it does, at reduced shapes, with
inputs made from a seed with numpy:

* the host's plan (``plan_launch``: shapes only) and the grid of
  (b, h, P-slice) CTAs of 4 or 8 warps, each owning ``p_slice`` of a
  head's 64 state rows and y columns;
* per chunk, l = cumsum(dt * a) in log2 units over slots past q held at
  dt = 0 (the masked ragged rows, with zero x/B/C), and the 16-row query
  tiles each warp takes (tiles w and 2W - 1 - w of every 2W);
* per query tile, 2^l_i (C_i . S_prev^T) with S_prev's operand rounded
  to bf16, then the lower-triangular 16-key tiles: C_i . B_j^T in f32,
  times the decay and dt_j, rounded to bf16, times x_j; below the
  diagonal the decay splits at the key tile's last slot e into
  2^(l_i - l_e) and dt_j 2^(l_e - l_j), on the diagonal it is
  2^(l_i - l_j) dt_j where j <= i (masked before the exp);
  y = acc + D x rounded to bf16;
* the state update by the warps' 16-column groups and m16 tiles (all
  warps, or with 8 warps and at most 4 query tiles warps 4-7 alone):
  2^l_last S_prev + (x dt w)^T B with x dt w rounded to bf16, the state
  itself carried in f32 across chunks.

With ``rounding=False`` the replay is the same schedule in float32.
It is held to the port's plain version ``ssd_plain`` (in float32, on
the same bf16-valued inputs), to the JAX package's ``ssd_chunked`` and
to the Pallas kernel in interpret mode (as ``tests/test_torch_ssd.py``
runs them).  Tolerances, relative to the reference's largest
magnitude: float32 2e-5; bf16 2e-2 (the replay rounds where the kernel
does, the references do not).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import mamba2 as JM
from repro_torch.kernels import ssd_scan as ss

torch.set_num_threads(2)

TOL = {"f32": 2e-5, "bf16": 2e-2}
P = ss.HEAD_DIM
SMS = 132            # an H100 SXM's SM count


def _bf16(a):
    """Round to bf16 (nearest even) and back, as the kernel's packs do."""
    return (torch.from_numpy(np.ascontiguousarray(a, np.float32))
            .to(torch.bfloat16).float().numpy())


def warp_tiles(warp: int, qt: int, warps: int):
    """The 16-row query tiles warp ``warp`` of ``warps`` takes of a
    chunk's ``qt``."""
    group = 2 * warps
    out = []
    for k in range(2 * (-(-qt // group))):
        it = group * (k // 2) + (group - 1 - warp if k % 2 else warp)
        if it < qt:
            out.append(it)
    return out


def state_units(warp: int, warps: int, qt: int, n: int, p_slice: int):
    """The (16-column group, m16 tile) pairs of the state update that warp
    ``warp`` owns."""
    wp, pw = warps, warp
    if warps == 8 and qt <= 4:               # warps 4-7 alone
        if warp < 4:
            return []
        wp, pw = 4, warp - 4
    nk = n // 16
    gw = max(1, wp // nk)
    ng = max(1, 8 // wp)
    return [(pw // gw + k * (wp // gw), mt) for k in range(ng)
            for mt in range(p_slice // 16)
            if pw // gw + k * (wp // gw) < nk and mt % gw == pw % gw]


def replay(x, dt, a_log, B, C, d_skip, chunk, init=None, plan=None,
           rounding=True):
    """The bf16 body's schedule on numpy arrays (x/B/C already holding
    bf16 values when ``rounding``); returns (y, final state) in f32."""
    b, S, H, _ = x.shape
    G, N = B.shape[2], B.shape[3]
    p_slice, warps = plan or ss.plan_launch(b, H, chunk, N, SMS)
    rnd = _bf16 if rounding else (lambda a: np.asarray(a, np.float32))
    f32 = np.float32
    y = np.zeros((b, S, H, P), f32)
    fstate = np.zeros((b, H, P, N), f32)
    Qp = -(-chunk // 16) * 16
    for cta in range(ss.grid_ctas(b, H, p_slice)):
        bh, p0 = divmod(cta, P // p_slice)
        p0 *= p_slice
        bi, h = divmod(bh, H)
        g = h // (H // G)
        a2 = f32(-np.exp(f32(a_log[h])) * np.log2(np.e))
        ps = slice(p0, p0 + p_slice)
        sf = (np.zeros((p_slice, N), f32) if init is None
              else init[bi, h, ps].astype(f32))
        for c0 in range(0, S, chunk):
            q = min(chunk, S - c0)
            qt = -(-q // 16)
            dts = np.zeros(Qp, f32)
            dts[:q] = dt[bi, c0:c0 + q, h]
            ls = np.cumsum(dts * a2, dtype=f32)          # log2 units
            l_last = ls[Qp - 1]
            wfs = dts * np.exp2(l_last - ls)
            ends = ls[np.arange(Qp) | 15]                # l at the tile end
            ujs = dts * np.exp2(ends - ls)
            cs = np.zeros((qt * 16, N), f32)
            bs = np.zeros((qt * 16, N), f32)
            xs = np.zeros((qt * 16, p_slice), f32)
            cs[:q], bs[:q] = C[bi, c0:c0 + q, g], B[bi, c0:c0 + q, g]
            xs[:q] = x[bi, c0:c0 + q, h, ps]
            has_state = c0 > 0 or init is not None
            sb = rnd(sf)
            seen = []
            for w in range(warps):
                for it in warp_tiles(w, qt, warps):
                    seen.append(it)
                    rows = slice(16 * it, 16 * it + 16)
                    i = np.arange(16 * it, 16 * it + 16)[:, None]
                    li = ls[rows][:, None]
                    acc = np.zeros((16, p_slice), f32)
                    if has_state:
                        acc = np.exp2(li) * (cs[rows] @ sb.T)
                    for jt in range(it + 1):
                        cols = slice(16 * jt, 16 * jt + 16)
                        j = np.arange(16 * jt, 16 * jt + 16)[None, :]
                        s = cs[rows] @ bs[cols].T
                        if jt < it:                      # below the diagonal
                            s = (s * np.exp2(li - ls[16 * jt + 15])
                                 * ujs[cols][None])
                        else:                            # masked before the exp
                            e = np.exp2(np.minimum(li - ls[cols][None], 0))
                            s = np.where(j <= i, s * e * dts[cols][None], 0)
                        acc = acc + rnd(s) @ xs[cols]
                    out = acc + f32(d_skip[h]) * xs[rows]
                    keep = i[:, 0] < q
                    y[bi, c0 + 16 * it + np.flatnonzero(keep), h, ps] = \
                        rnd(out[keep])
            assert sorted(seen) == list(range(qt))       # each tile once
            u = rnd(xs * wfs[:qt * 16, None])              # (x dt w), bf16
            new = sf.copy()
            units = sorted(unit for w in range(warps)
                           for unit in state_units(w, warps, qt, N, p_slice))
            assert units == [(n16, mt) for n16 in range(N // 16)
                             for mt in range(p_slice // 16)]  # each once
            for n16, mt in units:
                r = slice(16 * mt, 16 * mt + 16)
                c = slice(16 * n16, 16 * n16 + 16)
                new[r, c] = (np.exp2(l_last) * sf[r, c]
                             + u[:, r].T @ bs[:, c])
            sf = new
        fstate[bi, h, ps] = sf
    return y, fstate


def _inputs(seed, b, S, H, G, N, init, bf16):
    """The card tests' distributions (``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) - 2.0)
                  ).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    d_skip = np.ones(H, np.float32)
    st = ((rng.standard_normal((b, H, P, N)) * 0.1).astype(np.float32)
          if init else None)
    if bf16:
        x, B, C = _bf16(x), _bf16(B), _bf16(C)
    return x, dt, a_log, B, C, d_skip, st


def _plain(x, dt, a_log, B, C, d_skip, chunk, st):
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, dt, a_log, B, C, d_skip, st)]
    y, f = ss.ssd_plain(*t[:6], chunk, t[6])
    return y.numpy(), f.numpy()


def _close(out, ref, tol):
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert np.isfinite(out).all()
    assert err <= tol * scale, (err, tol * scale)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,H,chunk,N,want,ctas", [
    (4, 80, 64, 128, (64, 8), 320),   # mamba2-2.7b chunk step, 4 slots
    (2, 80, 64, 128, (64, 4), 160),   # 2 slots: two 4-warp CTAs an SM
    (1, 80, 64, 128, (64, 8), 80),    # 1 slot
    (2, 64, 256, 64, (64, 8), 128),   # zamba2-1.2b bucket, 2 rows
    (1, 64, 256, 64, (32, 8), 128),   # 1 row: two slices a head
    (4, 80, 256, 128, (32, 8), 640),  # a whole head would not fit
    (2, 8, 32, 16, (32, 8), 32),      # the reduced models
])
def test_plan_from_shapes(b, H, chunk, N, want, ctas):
    plan = ss.plan_launch(b, H, chunk, N, SMS)
    assert tuple(plan) == want
    assert ss.grid_ctas(b, H, plan.p_slice) == ctas
    # what the rule promises: the CTA fits the card's shared memory;
    # 8-warp CTAs (one an SM) within the SMs or past two an SM, 4-warp
    # CTAs (two an SM) in between; slices where they still fit one an SM
    # or a whole head does not fit
    assert ss.tc_smem_bytes(chunk, N, plan.p_slice) <= ss.MAX_SMEM
    per_sm = 1 if plan.warps == 8 else 2
    if plan.warps == 4:
        assert 2 * ss.tc_smem_bytes(chunk, N, plan.p_slice) <= ss.MAX_SMEM
    assert ctas <= per_sm * SMS or ctas > 2 * SMS
    if plan.p_slice < P:
        assert (ctas <= SMS
                or ss.tc_smem_bytes(chunk, N, P) > ss.MAX_SMEM)


def test_plan_reads_shapes_only():
    """Ints in, a plan out: the wrapper computes it from the operands'
    shapes and the card's SM count, never from a tensor's values."""
    assert ss.plan_launch(4, 80, 64, 128, SMS) == ss.plan_launch(
        4, 80, 64, 128, SMS)
    assert ss.plan_launch(4, 80, 64, 128, 5 * SMS) == (32, 8)  # a bigger card
    assert ss.plan_launch(4, 80, 64, 128, 1) == (64, 8)


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("qt", list(range(1, 17)))
def test_warps_take_every_tile_once(qt, warps):
    tiles = sorted(t for w in range(warps) for t in warp_tiles(w, qt, warps))
    assert tiles == list(range(qt))
    if qt % (2 * warps) == 0:    # whole groups: equal triangle work
        work = {sum(t + 1 for t in warp_tiles(w, qt, warps))
                for w in range(warps)}
        assert len(work) == 1


@pytest.mark.parametrize("plan", [(64, 8), (32, 8), (64, 4)])
@pytest.mark.parametrize("n", [16, 48, 64, 128])
@pytest.mark.parametrize("qt", [1, 4, 16])
def test_state_update_owns_every_unit_once(plan, n, qt):
    p_slice, warps = plan
    units = sorted(u for w in range(warps)
                   for u in state_units(w, warps, qt, n, p_slice))
    assert units == [(n16, mt) for n16 in range(n // 16)
                     for mt in range(p_slice // 16)]


# ---------------------------------------------------------------------------
# the replay against the references
# ---------------------------------------------------------------------------
# (b, S, H, G, N, chunk, init, plan): served shapes cut to few heads,
# the ragged chunks the card tests run, G 2, N 16 and 48, a carried state
# over eight chunks, every plan the kernel takes
CASES = [
    (2, 64, 4, 1, 128, 64, True, (64, 8)),    # mamba2 chunk step
    (1, 17, 4, 1, 128, 64, True, (64, 4)),    # ragged chunk step
    (1, 272, 2, 1, 64, 256, False, (32, 8)),  # zamba2 bucket: last chunk 16
    (1, 416, 2, 1, 64, 256, False, (64, 8)),  # last chunk 160
    (2, 72, 4, 2, 32, 32, True, (32, 8)),     # G 2, ragged
    (1, 40, 2, 1, 16, 32, False, (64, 4)),    # N 16
    (1, 100, 2, 1, 48, 64, True, (64, 8)),    # N 48: a group of warps idle
    (1, 512, 1, 1, 64, 64, True, (32, 8)),    # eight chunks carry the state
]


@pytest.mark.parametrize("b,S,H,G,N,chunk,init,plan", CASES)
def test_replay_f32_matches_plain(b, S, H, G, N, chunk, init, plan):
    arrs = _inputs(0, b, S, H, G, N, init, bf16=False)
    y, f = replay(*arrs[:6], chunk, arrs[6], plan, rounding=False)
    y_ref, f_ref = _plain(*arrs[:6], chunk, arrs[6])
    _close(y, y_ref, TOL["f32"])
    _close(f, f_ref, TOL["f32"])


@pytest.mark.parametrize("b,S,H,G,N,chunk,init,plan", CASES)
def test_replay_bf16_matches_plain(b, S, H, G, N, chunk, init, plan):
    """The kernel's rounding points against the plain version in f32 on
    the same bf16 inputs, y rounded to bf16 as the kernel stores it."""
    arrs = _inputs(1, b, S, H, G, N, init, bf16=True)
    y, f = replay(*arrs[:6], chunk, arrs[6], plan)
    y_ref, f_ref = _plain(*arrs[:6], chunk, arrs[6])
    _close(y, y_ref, TOL["bf16"])
    _close(f, f_ref, TOL["bf16"])


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("S,chunk,G", [(128, 32, 1), (80, 32, 2)])
def test_replay_matches_jax_ssd_chunked(rounding, S, chunk, G):
    """The JAX oracle, on inputs padded to whole chunks with dt = 0 and
    zero x/B/C (it asserts on a ragged S), y cut back."""
    b, H, N = 2, 4, 32
    arrs = _inputs(2, b, S, H, G, N, True, bf16=rounding)
    y, f = replay(*arrs[:6], chunk, arrs[6], rounding=rounding)
    x, dt, a_log, B, C, d_skip, st = arrs
    pad = -S % chunk
    padt = lambda a: np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    y_j, f_j = JM.ssd_chunked(
        jnp.asarray(padt(x)), jnp.asarray(padt(dt)), jnp.asarray(a_log),
        jnp.asarray(padt(B)), jnp.asarray(padt(C)), jnp.asarray(d_skip),
        chunk, init_state=jnp.asarray(st))
    tol = TOL["bf16" if rounding else "f32"]
    _close(y, np.asarray(y_j)[:, :S], tol)
    _close(f, np.asarray(f_j), tol)


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("S,chunk,N", [(128, 32, 32), (64, 64, 64)])
def test_replay_matches_pallas_ssd_scan(rounding, S, chunk, N):
    """The TPU kernel itself (Pallas, interpret mode; G 1, zero initial
    state, S a multiple of the chunk)."""
    b, H = 1, 4
    arrs = _inputs(3, b, S, H, 1, N, False, bf16=rounding)
    y, f = replay(*arrs[:6], chunk, None, rounding=rounding)
    y_j, f_j = pallas_ssd(*(jnp.asarray(a) for a in arrs[:6]), chunk=chunk,
                          interpret=True)
    tol = TOL["bf16" if rounding else "f32"]
    _close(y, np.asarray(y_j), tol)
    _close(f, np.asarray(f_j), tol)
