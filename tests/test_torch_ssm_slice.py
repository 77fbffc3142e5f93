"""The port's SSM and hybrid families (reduced mamba2-2.7b, zamba2-1.2b)
against the JAX package's, on the CPU.

* the pool's SSM state accounting replays a scripted sequence of
  operations exactly;
* the whole-prompt SSM prefill of a prompt whose padded length the
  chunk does not divide (the JAX package asserts there) matches the
  JAX package's chunked prefill of the same prompt: logits, SSM state
  and conv tail;
* a decode step that rolls back restores the SSM state of its rows
  exactly;
* served parity under the deterministic ``TickCostModel`` clock, the
  JAX package's weights carried across with ``params_to_torch``: equal
  greedy tokens and ``ServeReport.to_json()``, pools within 2e-5
  (float32; the two frameworks sum in different orders).  The traces
  are ones the JAX package can serve: prompts of at most 32 tokens
  where a hybrid engine prefills whole prompts, since the reference
  fails on padded lengths of 48, 80, ... (not multiples of the
  reduced models' 32-token chunk).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.core.workload import synthesize as jsynthesize
from repro.models.transformer import init_params as jinit
from repro.serving import driver as JD
from repro.serving import engine as JE
from repro.serving import kvcache as JK
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.core.workload import synthesize as tsynthesize
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import driver as TD
from repro_torch.serving import engine as TE
from repro_torch.serving import kvcache as TK

torch.set_num_threads(2)


def _trees(archs, seed0=0):
    """The JAX package's float32 weights (``PRNGKey(seed0 + i)``, what
    its ``build_unit_from_specs`` draws) and the same carried across."""
    jtrees = [jinit(jax.random.PRNGKey(seed0 + i), jconfigs.get_reduced(a),
                    jnp.float32) for i, a in enumerate(archs)]
    return jtrees, [params_to_torch(jax.tree_util.tree_map(np.asarray, t),
                                    "cpu") for t in jtrees]


# ---------------------------------------------------------------------------
# pool accounting
# ---------------------------------------------------------------------------
def _accounting_script(pool, config, configs):
    views = {n: pool.register_model(config.replace(configs.get_reduced(a),
                                                   name=n), q)
             for n, a, q in [("q", "qwen2-7b", 400), ("m", "mamba2-2.7b", 60),
                             ("z", "zamba2-1.2b", 120)]}
    m, z = views["m"], views["z"]
    out = [m._ssm_blocks_per_seq, z._ssm_blocks_per_seq, z.group_size]

    def state():
        return (pool.allocator.used, dict(pool.used_by),
                {n: (v.quota, v.used, v.quota_headroom())
                 for n, v in views.items()})
    for sid, n in [(0, 30), (1, 5), (2, 70)]:
        out.append((m._blocks_needed(sid, n), m.append_tokens(sid, n),
                    z._blocks_needed(sid, n), z.append_tokens(sid, n)))
        out.append(state())
    for _ in range(40):                      # decode growth
        out.append((m.append_tokens(0, 1), z.append_tokens(0, 1)))
    out.append(state())
    out.append((m._blocks_needed(0, 1), m._blocks_needed(9, 1),
                m.can_append(9, 1), z.can_append(9, 400)))
    m.free_seq(1)
    z.free_seq(1)
    m.free_seq(1)                            # a second free is a no-op
    out.append(state())
    m.quota = m.used                         # no headroom: a new seq fails
    out.append((m.append_tokens(5, 1), m.append_tokens(0, 1), state()))
    pool.adapt_quotas(min_quota=8)
    for sid in (0, 2):
        m.free_seq(sid)
        z.free_seq(sid)
    out.append(state())
    return out


def test_ssm_accounting_replays_identically():
    jpool = JK.UnifiedKVPool(2000, 64, dtype=jnp.float32)
    tpool = TK.UnifiedKVPool(2000, 64, dtype=torch.float32, device="cpu")
    jout = _accounting_script(jpool, jconfig, jconfigs)
    tout = _accounting_script(tpool, tconfig, tconfigs)
    assert tout == jout
    assert tout[0] == 8 and tout[1] == 16          # state bytes / 8 KB
    assert tpool.allocator.used == 0 and tpool.used_by == {"q": 0, "m": 0,
                                                           "z": 0}


def test_unit_pool_head_dim_skips_attention_free_models():
    """An attention-free model has no KV head_dim (mamba2's ``hd`` is
    d_model): the pool takes the attention models' head_dim, 64 when
    there are none; differing attention head_dims still raise."""
    unit = TD.build_unit_from_specs([("q", "qwen2-7b", 1.0),
                                     ("m", "mamba2-2.7b", 1.0)],
                                    pool_blocks=64, dtype=torch.float32,
                                    device="cpu")
    assert unit.pool.head_dim == 64
    solo = TD.build_unit_from_specs([("m", "mamba2-2.7b", 1.0)],
                                    pool_blocks=64, dtype=torch.float32,
                                    device="cpu")
    assert solo.pool.head_dim == 64
    with pytest.raises(ValueError, match="head_dim"):
        TD.build_unit_from_specs([("q", "qwen2-7b", 1.0),
                                  ("z", "zamba2-1.2b", 1.0)],
                                 pool_blocks=64, reduced=False,
                                 device="cpu")


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def test_padded_whole_prompt_matches_reference_chunked_prefill():
    """A 40-token prompt pads to 48, which the 32-token chunk does not
    divide: the port's whole-prompt SSM prefill (padded scan) must equal
    the JAX package's chunked prefill (16-token chunks, state carried)."""
    cfg_j = jconfigs.get_reduced("mamba2-2.7b")
    cfg_t = tconfigs.get_reduced("mamba2-2.7b")
    (jp,), (tp,) = _trees(["mamba2-2.7b"], seed0=7)
    prompt = np.random.default_rng(0).integers(1, cfg_j.vocab_size, 40)
    sc = cfg_j.ssm
    conv_dim = cfg_j.d_inner + 2 * sc.n_groups * sc.d_state
    st = jnp.zeros((cfg_j.n_layers, 1, cfg_j.n_ssm_heads, sc.head_dim,
                    sc.d_state), jnp.float32)
    tail = jnp.zeros((cfg_j.n_layers, 1, sc.conv_kernel - 1, conv_dim),
                     jnp.float32)
    stacked = jax.tree_util.tree_map(lambda a: a[None], jp)
    for c0 in range(0, 40, 16):
        chunk = np.zeros((1, 16), np.int32)
        n = min(16, 40 - c0)
        chunk[0, :n] = prompt[c0:c0 + n]
        logits_j, st, tail = JE._prefill_chunk_ssm_impl(
            stacked, 0, jnp.asarray(chunk), jnp.asarray([n]), st, tail,
            cfg=cfg_j)

    toks = np.zeros((1, 48), np.int32)
    toks[0, :40] = prompt
    pool = TK.UnifiedKVPool(16, 64, dtype=torch.float32, device="cpu")
    logits_t, st_t, tail_t = TE._prefill_ssm_step(
        TE.tree_map(lambda a: a[None], tp), 0, toks, np.array([40], np.int32),
        pool, np.full((1, 4), -1, np.int32), cfg=cfg_t)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **tol)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st), **tol)
    np.testing.assert_allclose(tail_t.numpy(), np.asarray(tail), **tol)


def _rollback_run(pkg, tree, prompts, roll: bool):
    """Prefill two zamba2 requests whose next token opens a new block,
    optionally starve the quota for one decode tick (every row rolls
    back), then decode to the end.  Returns the outputs and, when
    rolling back, whether the engine's SSM state survived unchanged."""
    K, E, cfg_mod, configs_mod = pkg
    cfg = cfg_mod.replace(configs_mod.get_reduced("zamba2-1.2b"), name="z")
    if K is JK:
        pool = K.UnifiedKVPool(2000, 64, dtype=jnp.float32)
    else:
        pool = K.UnifiedKVPool(2000, 64, dtype=torch.float32, device="cpu")
    eng = E.Engine(cfg, tree, pool.register_model(cfg, 2000), max_slots=4)
    reqs = [E.Request(i, "z", list(p), 6) for i, p in enumerate(prompts)]
    eng.prefill(reqs)
    kept = None
    if roll:
        before = (np.array(eng.ssm_state), np.array(eng.conv_tail))
        eng.view.quota = eng.view.used
        assert eng.decode() == 0                    # every row rolled back
        kept = (np.array_equal(np.array(eng.ssm_state), before[0])
                and np.array_equal(np.array(eng.conv_tail), before[1]))
        eng.view.quota = 2000
    while eng.has_decode_work():
        eng.decode()
    assert pool.allocator.used == 0
    return [r.output for r in reqs], kept


def test_decode_rollback_restores_the_ssm_state():
    (jp,), (tp,) = _trees(["zamba2-1.2b"], seed0=2)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, 15), rng.integers(1, 512, 31)]
    jpkg = (JK, JE, jconfig, jconfigs)
    tpkg = (TK, TE, tconfig, tconfigs)
    out_j, kept_j = _rollback_run(jpkg, jp, prompts, roll=True)
    out_t, kept_t = _rollback_run(tpkg, tp, prompts, roll=True)
    straight, _ = _rollback_run(tpkg, tp, prompts, roll=False)
    assert kept_j and kept_t
    assert out_t == out_j == straight
    assert all(len(o) == 6 for o in out_t)


# ---------------------------------------------------------------------------
# served parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("archs,chunk,max_len", [
    (("mamba2-2.7b", "qwen2-7b", "qwen2-7b"), 16, 128),
    (("zamba2-1.2b", "mamba2-2.7b", "qwen2-7b"), 0, 32),
    (("zamba2-1.2b", "mamba2-2.7b", "qwen2-7b"), 16, 32),
])
def test_served_slice_matches_reference(archs, chunk, max_len):
    names = [f"llm{i}" for i in range(len(archs))]
    trace = dict(alpha=1.0, max_rate=12.0, horizon=1.0, seed=0,
                 mean_prompt=24, mean_output=8, max_len=max_len)
    wl_j, wl_t = jsynthesize(names, **trace), tsynthesize(names, **trace)
    specs = [(n, a, wl_j.rates[n]) for n, a in zip(names, archs)]
    common = dict(pool_blocks=4000, max_slots=4, chunk_tokens=chunk,
                  policy="adbs", fused=True)
    uj = JD.build_unit_from_specs(specs, **common)
    rj = JD.serve_workload([uj], wl_j, seed=0, cost=JD.TickCostModel())
    _, trees = _trees(archs)
    ut = TD.build_unit_from_specs(specs, dtype=torch.float32, device="cpu",
                                  params=trees, **common)
    rt = TD.serve_workload([ut], wl_t, seed=0, cost=TD.TickCostModel())

    assert [g.names for g in ut.fused_groups] == \
        [g.names for g in uj.fused_groups]
    assert sorted(ut._serial_names) == sorted(uj._serial_names)
    per_model = {n: sum(r.model == n for r in wl_j.requests) for n in names}
    assert min(per_model.values()) >= 3, per_model
    tok_j = {r.req_id: r.output for r in uj.stats.finished}
    tok_t = {r.req_id: r.output for r in ut.stats.finished}
    assert len(tok_j) == len(wl_j.requests)
    assert tok_t == tok_j
    a, b = rj.to_json(), rt.to_json()
    a.pop("wall_s")
    b.pop("wall_s")
    assert b == a
    assert ut.pool.allocator.used == uj.pool.allocator.used == 0
    np.testing.assert_allclose(ut.pool.k.numpy(), np.asarray(uj.pool.k),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ut.pool.v.numpy(), np.asarray(uj.pool.v),
                               rtol=2e-5, atol=2e-5)
    for name in names:
        eng_t, eng_j = ut.engines[name], uj.engines[name]
        if eng_t.cfg.ssm:
            np.testing.assert_allclose(eng_t.ssm_state.numpy(),
                                       np.asarray(eng_j.ssm_state),
                                       rtol=2e-5, atol=2e-5)
