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
* A numpy replay of the kernel's schedule (``csrc/moe_grouped.cu``): the
  worst-case grid (``m_tiles`` M tiles × 64-column N tiles), each CTA's
  (expert, M tile) found from ``offsets`` by the block scan, CTAs with no
  tile exiting, the gate/up rows written at their sorted position and
  the down rows at their slot, each exactly once, against the plain
  version (float64 replay, 2e-5).  The same routings, and the grid's
  bound on adversarial counts.
"""
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


def replay_schedule(x, order, offsets, wg, wu, wd, k):
    """The kernel's two launches replayed in numpy (float64): every CTA
    of the fixed grid, its tile found from ``offsets`` alone.  Returns
    (y [n, d], CTAs that found a tile per launch, grid CTAs per
    launch); asserts every act and y element is written exactly once."""
    n, (E, d, f) = len(order), wg.shape
    BM, BN = MG.BM, MG.BN
    grid_m = MG.m_tiles(n, E)
    act = np.zeros((n, f))
    y = np.zeros((n, d))
    writes = {"act": np.zeros((n, f), int), "y": np.zeros((n, d), int)}
    busy = {}
    for launch, N in (("act", f), ("y", d)):
        busy[launch] = 0
        for tm in range(grid_m):
            # the block scan: thread e counts expert e's tiles
            counts = [-(-(offsets[e + 1] - offsets[e]) // BM)
                      for e in range(E)]
            starts = np.concatenate([[0], np.cumsum(counts)])
            hit = [e for e in range(E)
                   if starts[e] <= tm < starts[e] + counts[e]]
            if not hit:
                continue                          # a CTA with no tile
            assert len(hit) == 1
            e = hit[0]
            row0 = offsets[e] + (tm - starts[e]) * BM
            rows = [i for i in range(row0, row0 + BM) if i < offsets[e + 1]]
            for tn in range(-(-N // BN)):
                busy[launch] += 1
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
    return y, busy, {"act": grid_m * -(-f // BN), "y": grid_m * -(-d // BN)}


@pytest.mark.parametrize("name,idx,E", _routings(),
                         ids=[r[0] for r in _routings()])
def test_tile_schedule_replay_matches_plain(name, idx, E):
    T, k = idx.shape
    d, f = 72, 80          # a ragged N tile in both launches
    rng = np.random.default_rng(E + T)
    x = rng.standard_normal((T, d))
    wg, wu = (rng.standard_normal((E, d, f)) / np.sqrt(d) for _ in range(2))
    wd = rng.standard_normal((E, f, d)) / np.sqrt(f)
    order, offsets = MG.sort_slots(torch.from_numpy(idx), E)
    o, off = order.numpy(), offsets.numpy()
    y, busy, grid = replay_schedule(x, o, off, wg, wu, wd, k)
    plain = MG.grouped_swiglu_plain(
        *(torch.from_numpy(a.astype(np.float32)) for a in (x,)), order,
        offsets, *(torch.from_numpy(a.astype(np.float32))
                   for a in (wg, wu, wd)), k)
    np.testing.assert_allclose(plain.numpy(), y, rtol=2e-5, atol=2e-5)
    tiles = sum(-(-(off[e + 1] - off[e]) // MG.BM) for e in range(E))
    assert busy == {"act": tiles * -(-f // MG.BN),
                    "y": tiles * -(-d // MG.BN)}
    assert all(busy[n] <= grid[n] for n in grid)


def test_grid_bounds_every_routing():
    """Σₑ ⌈nₑ / BM⌉ ≤ ``m_tiles(n, E)`` for any counts summing to n, the
    bound met with equality where every non-empty expert holds one slot
    past a multiple of BM."""
    rng = np.random.default_rng(1)
    BM = MG.BM
    for E in (1, 4, 32, 128):
        for n in (1, 7, 8, 32, 64, 512, 2048):
            m = MG.m_tiles(n, E)
            for _ in range(20):
                counts = rng.multinomial(n, rng.dirichlet(np.ones(E) * 0.3))
                assert sum(-(-c // BM) for c in counts) <= m
            # the worst case: as many experts as can hold BM·j + 1 slots
            worst = np.zeros(E, int)
            for i in range(n):
                worst[i % E] += 1
            assert sum(-(-c // BM) for c in worst) <= m
    assert MG.m_tiles(32, 128) == 32 and MG.m_tiles(512, 32) == 62
    assert MG.m_tiles(16 * 9, 1) == 9
