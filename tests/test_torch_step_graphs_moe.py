"""The MoE family's compiled serving steps (``serving/graphs.py``) on the
CPU: reduced granite-moe-3b-a800m and qwen3-moe-235b-a22b, float32,
weights from the JAX package's ``init_params`` carried across with
``params_to_torch``.

* The fixed-shape bodies of the MoE ``prefill``, ``chunk`` and
  ``decode`` steps — whose dropless FFN now sorts the slots by expert
  on the device and runs the grouped-expert SwiGLU — against the same
  steps with the port's dropless FFN as it was before (counts read on
  the host; ``test_torch_moe_grouped._old_dropless``) bit for bit, and
  against the JAX package's ``_prefill_impl`` / ``_prefill_chunk_impl``
  / ``_decode_impl``: the arena entries each package leaves untouched
  are the same and untouched, logits and written entries within 2e-5.
* The registry, through the capture stub of ``test_torch_step_graphs``:
  MoE units (beside dense neighbours, chunked and whole-prompt) served
  with graphs give the eager run's tokens and ``ServeReport`` and the
  JAX package's; one program per bucket and kind, the MoE engine's
  ``prefill`` / ``chunk`` / ``decode`` among them; a reallocating
  ``grow`` drops every MoE graph on the old arena and recaptures each
  step once; crash recovery's fresh engine captures its steps anew;
  both with the eager run's tokens and report.
"""
import contextlib
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.models.transformer import init_params as jinit
from repro.serving import engine as JE
from repro_torch import configs
from repro_torch.models import moe as TMoE
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import driver as TD
from repro_torch.serving import engine as TE
from repro_torch.serving import graphs
from repro_torch.serving.kvcache import UnifiedKVPool

import test_torch_moe_slice as TMS
from test_torch_moe_grouped import _old_dropless
from test_torch_step_graphs import RecordingCapture
from test_torch_step_graphs_ssm import _mixed_unit, _serve

torch.set_num_threads(2)

MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
N_BLOCKS = 256           # arena head-blocks of the body tests
W = 4                    # table width of the body tests (64 tokens a row)
TOL = 2e-5


@pytest.fixture
def stub():
    saved = graphs.REGISTRY.capture
    graphs.REGISTRY.clear()
    graphs.REGISTRY.capture = rec = RecordingCapture()
    try:
        yield rec
    finally:
        graphs.REGISTRY.capture = saved
        graphs.REGISTRY.clear()


# ---------------------------------------------------------------------------
# the bodies against the old FFN and the JAX steps
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in MOE_ARCHS:
        jcfg = jconfigs.get_reduced(arch)
        trees = [jax.tree_util.tree_map(np.asarray, jinit(
            jax.random.PRNGKey(i), jcfg, jnp.float32)) for i in range(2)]
        jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *trees)
        ported = [params_to_torch(t, "cpu") for t in trees]
        tstack = {g: {k: torch.stack([t[g][k] for t in ported])
                      for k in ported[0][g]} for g in ported[0]}
        out[arch] = (jcfg, jstack, tstack)
    return out


def _inputs(kind: str, arch: str, case: str, seed: int) -> dict:
    """One step's host arrays: ``prefill`` four rows of 32 tokens (the
    last padded: −1 table, length 0; row 1's table cut after a block),
    ``chunk`` four 16-token chunks at block offsets (the last padded),
    ``decode`` four rows (the last padded); ``none``: every table −1."""
    rng = np.random.default_rng(seed)
    cfg = configs.get_reduced(arch)
    gs = cfg.n_layers * cfg.n_kv_heads
    B = 4
    table = (rng.permutation(N_BLOCKS // gs)[:B * W] * gs).reshape(
        B, W).astype(np.int32)
    table[-1] = -1
    a = dict(table=table)
    if kind == "prefill":
        lens = np.array([32, 20, 7, 0], np.int32)
        toks = rng.integers(1, cfg.vocab_size, (B, 32)).astype(np.int32)
        toks[np.arange(32)[None, :] >= lens[:, None]] = 0
        table[1, 1:] = -1
        a.update(toks=toks, lens=lens)
    elif kind == "chunk":
        clens = np.array([16, 9, 1, 0], np.int32)
        offs = np.array([0, 16, 32, 0], np.int32)
        toks = rng.integers(1, cfg.vocab_size, (B, 16)).astype(np.int32)
        toks[np.arange(16)[None, :] >= clens[:, None]] = 0
        a.update(toks=toks, offs=offs, clens=clens)
    else:
        lens = np.array([20, 33, 5, 1], np.int32)
        a.update(toks=rng.integers(1, cfg.vocab_size, B).astype(np.int32),
                 lens=lens)
    if case == "none":
        table[:] = -1
    return a


def _port_pool(pk, pv):
    pool = UnifiedKVPool(N_BLOCKS, pk.shape[-1], torch.float32, device="cpu")
    pool.k.copy_(torch.from_numpy(pk))
    pool.v.copy_(torch.from_numpy(pv))
    return pool


CASES = [(kind, arch, case) for arch in MOE_ARCHS
         for kind in ("prefill", "chunk", "decode")
         for case in ("padded", "none")]


def _run_three(kind, arch, case, weights):
    """(port step, port step with the old FFN, JAX step) on the same
    inputs, each (logits, k arena, v arena) as numpy arrays."""
    jcfg, jstack, tstack = weights[arch]
    cfg = configs.get_reduced(arch)
    seed = CASES.index((kind, arch, case))
    a = _inputs(kind, arch, case, seed)
    rng = np.random.default_rng(100 + seed)
    pk, pv = (rng.standard_normal((N_BLOCKS, 16, cfg.hd)).astype(np.float32)
              for _ in range(2))
    midx = 1
    res = {}
    for which in ("new", "old"):
        pool = _port_pool(pk, pv)
        saved = TMoE.moe_ffn_dropless
        if which == "old":
            TMoE.moe_ffn_dropless = _old_dropless
        try:
            if kind == "prefill":
                lg = TE._prefill_step(tstack, midx, a["toks"], a["lens"],
                                      pool, a["table"], cfg=cfg)
            elif kind == "chunk":
                lg = TE._prefill_chunk_step(tstack, midx, a["toks"],
                                            a["offs"], a["clens"], pool,
                                            a["table"], cfg=cfg)
            else:
                lg = TE._decode_step(tstack, midx, a["toks"], a["lens"],
                                     pool, a["table"], cfg=cfg)
        finally:
            TMoE.moe_ffn_dropless = saved
        res[which] = tuple(t.numpy().copy() for t in (lg, pool.k, pool.v))
    j = {k: jnp.asarray(x) for k, x in a.items()}
    jpk, jpv = jnp.asarray(pk), jnp.asarray(pv)
    if kind == "prefill":
        jk, jv, jl, _, _ = JE._prefill_impl(jstack, midx, j["toks"],
                                            j["lens"], jpk, jpv, j["table"],
                                            cfg=jcfg)
    elif kind == "chunk":
        jk, jv, jl = JE._prefill_chunk_impl(
            jstack, midx, j["toks"], j["offs"], j["clens"], jpk, jpv,
            j["table"], cfg=jcfg)
    else:
        jk, jv, jl, _, _ = JE._decode_impl(
            jstack, midx, j["toks"], j["lens"], jpk, jpv, j["table"], None,
            None, cfg=jcfg)
    res["jax"] = tuple(np.asarray(x) for x in (jl, jk, jv))
    res["arena"] = (pk, pv)
    return res


@pytest.mark.parametrize("kind,arch,case", CASES)
def test_moe_body_matches_old_ffn_and_reference(kind, arch, case, weights):
    res = _run_three(kind, arch, case, weights)
    new, old, ref = res["new"], res["old"], res["jax"]
    for a, b in zip(new, old):
        np.testing.assert_array_equal(a, b)
    for got, want, before in zip(new[1:], ref[1:], res["arena"]):
        wrote = (got != before).any(axis=-1)
        np.testing.assert_array_equal(wrote, (want != before).any(axis=-1))
        np.testing.assert_array_equal(got[~wrote], before[~wrote])
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        if case == "none":
            assert not wrote.any()
    np.testing.assert_allclose(new[0], ref[0], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the registry, through the capture stub
# ---------------------------------------------------------------------------
def _moe_keys(keys):
    return [k for k in keys if k[0][1] is not None and k[0][1].moe]


@pytest.mark.parametrize("archs,chunk", [
    (("granite-moe-3b-a800m", "qwen2-7b", "qwen2-7b"), 16),
    (("qwen3-moe-235b-a22b", "musicgen-medium"), 0),
])
def test_moe_units_serve_with_graphs_as_eager_and_reference(stub, archs,
                                                            chunk):
    """Served with graphs (through the stub), the MoE units give the JAX
    package's tokens and report (``test_torch_moe_slice``'s twins) and
    the eager run's; every key is captured once, one program per bucket
    and kind, the MoE engine's kinds among them."""
    cfgs = [jconfig.replace(jconfigs.get_reduced(a), name=f"{a}#{i}")
            for i, a in enumerate(archs)]
    wl_j, uj, ut, rj, rt = TMS._serve_both(cfgs, chunk)
    TMS._assert_same(wl_j, uj, ut, rj, rt)
    keys = list(stub.keys)
    moe = _moe_keys(keys)
    kinds = {k[0][0] for k in moe}
    assert ({"chunk", "decode"} if chunk else {"prefill", "decode"}) <= kinds
    assert len(keys) == len(set(keys))
    slots = [k[0][:4] for k in keys]
    assert len(slots) == len(set(slots))
    assert sum(g.replays for k, g in graphs.REGISTRY.graphs.items()
               if k in moe) > 0
    # the same trace eagerly: the same tokens and report
    names = [c.name for c in cfgs]
    trace = dict(alpha=1.0, max_rate=12.0, horizon=1.0, seed=0,
                 mean_prompt=24, mean_output=8, max_len=128)
    wl = TMS.tsynthesize(names, **trace)
    with graphs.disable_graphs():
        _, eager = TMS._units(cfgs, [wl.rates[n] for n in names], chunk)
        re = TD.serve_workload([eager], wl, seed=0, cost=TD.TickCostModel())
    assert len(stub.keys) == len(keys)
    assert {r.req_id: r.output for r in eager.stats.finished} == \
        {r.req_id: r.output for r in ut.stats.finished}
    a, b = re.to_json(), rt.to_json()
    a.pop("wall_s")
    b.pop("wall_s")
    assert a == b


MOE_PAIR = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")


def test_moe_graphs_recaptured_after_reallocating_grow(stub):
    """A ``grow`` past the arena's buffer under live sequences: every
    MoE graph (all read the arena) is dropped and each step recaptured
    at most once after it; tokens and report equal the eager run's with
    the same grow (at the first step where both engines have decoded
    twice)."""
    out = {}
    for mode in ("graphs", "eager"):
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            unit, reqs = _mixed_unit(16, archs=MOE_PAIR)
            seen = {}

            def grow(n, unit=unit, seen=seen):
                if "old" in seen or not all(
                        any(r is not None and len(r.output) >= 2
                            for r in e.slots)
                        for e in unit.engines.values()):
                    return
                pool = unit.pool
                k_old = pool.arena()[0]
                seen["old"] = {t.data_ptr() for t in pool.arena()}
                seen["before"] = dict(graphs.REGISTRY.graphs)
                seen["n0"] = len(stub.keys)
                pool.grow(k_old.shape[0] - pool.n_head_blocks + 512)
                assert pool.arena()[0] is not k_old
                del k_old
                gc.collect()
            out[mode] = _serve(unit, reqs, grow)
        if mode == "graphs":
            before = _moe_keys(seen["before"])
            assert before and all(seen["old"] & set(k[1]) for k in before)
            assert not set(before) & set(graphs.REGISTRY.graphs)
            later = [k[0] for k in _moe_keys(stub.keys[seen["n0"]:])]
            assert later and len(later) == len(set(later))
    assert out["graphs"] == out["eager"]


def test_moe_graphs_recaptured_after_recovery(stub):
    """Crash recovery rebuilds the MoE engine: its graphs go with the
    dead engine's weight leaves, the fresh engine's chunk and decode are
    captured anew, and tokens and report equal the eager run's with the
    same recovery (at the first step where a granite-moe request has
    decoded twice)."""
    out = {}
    for mode in ("graphs", "eager"):
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            unit, reqs = _mixed_unit(16, archs=MOE_PAIR)
            seen = {}

            def recover(n, unit=unit, seen=seen):
                old = unit.engines["llm0"]
                if "n0" in seen or not any(
                        r is not None and len(r.output) >= 2
                        for r in old.slots):
                    return
                seen["had"] = {k: g for k, g in graphs.REGISTRY.graphs.items()
                               if k in _moe_keys([k])
                               and k[0][1] == old.cfg_key}
                seen["n0"] = len(stub.keys)
                del old
                unit.recover_engine("llm0")
                gc.collect()
            out[mode] = _serve(unit, reqs, recover)
        if mode == "graphs":
            fresh = unit.engines["llm0"]
            assert seen["had"]
            # the dead engine's graphs are gone (a key the fresh engine
            # meets again holds a graph of its own)
            assert all(graphs.REGISTRY.graphs.get(k) is not g
                       for k, g in seen["had"].items())
            after = [k for k in stub.keys[seen["n0"]:]
                     if k[0][1] == fresh.cfg_key]
            assert {"chunk", "decode"} <= {k[0][0] for k in after}
    assert out["graphs"] == out["eager"]
