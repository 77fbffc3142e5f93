"""The port's MoE FFN (``repro_torch.models.moe``) and configs against the
JAX package's, on the CPU.

* Every config of ``repro.configs`` (published and reduced) is copied
  field for field, and the MoE parameter counts the estimator reads are
  equal.
* ``route``: the same expert indices (scores in float32 in both),
  gates and aux loss within f32 2e-5.
* ``expert_capacity``: equal integers.
* ``moe_ffn_dropless`` (grouped by expert in the port, per-token
  gathered weights in the reference) and ``moe_ffn`` (capacity
  dispatch, tokens past capacity dropped): outputs and aux loss within
  f32 rtol/atol 2e-5 (the frameworks sum in different orders), on the
  same seeded numpy inputs and the reference's weights carried across
  with ``params_to_torch``.
* The port's own trees: ``init_params`` gives the reference's MoE tree
  shapes, the router in float32 whatever the tree's dtype.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.models import moe as JM
from repro.models.transformer import init_params as jinit
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.models import moe as TM
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import params_to_torch

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_copies_equal_reference(arch):
    assert asdict(tconfigs.get(arch)) == asdict(jconfigs.get(arch))
    assert asdict(tconfigs.get_reduced(arch)) == \
        asdict(jconfigs.get_reduced(arch))
    t, j = tconfigs.get(arch), jconfigs.get(arch)
    assert t.hd == j.hd
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_registry_lists_all_ten():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert {k: asdict(v) for k, v in tconfigs.all_configs().items()} == \
        {k: asdict(v) for k, v in jconfigs.all_configs().items()}
    for dashed, mod in tconfigs.ALIASES.items():
        assert tconfigs.get(dashed) == tconfigs.get(mod)


# (n_experts, top_k, d_model, tokens): the two reduced configs, the
# full configs' expert counts at a small width
MOES = [(4, 2, 256, 24), (32, 8, 64, 40), (128, 8, 64, 33)]


def _moe_cfgs(E, k, d):
    fe = 48
    kw = dict(name="m", family="moe", n_layers=2, d_model=d, n_heads=4,
              n_kv_heads=2, d_ff=fe, vocab_size=64)
    jc = jconfig.ModelConfig(moe=jconfig.MoEConfig(E, k, fe), **kw)
    tc = tconfig.ModelConfig(moe=tconfig.MoEConfig(E, k, fe), **kw)
    return jc, tc


@pytest.mark.parametrize("E,k,d,T", MOES)
def test_route_picks_the_same_experts(E, k, d, T):
    rng = np.random.default_rng(E)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, E)) * 0.02).astype(np.float32)
    jc, tc = _moe_cfgs(E, k, d)
    jg, ji, ja = JM.route(jnp.asarray(x), jnp.asarray(w), jc.moe)
    tg, ti, ta = TM.route(torch.from_numpy(x), torch.from_numpy(w), tc.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    # a bf16 activation is scored in float32 too: the same experts
    xb = x.astype(jnp.bfloat16)
    _, jib, _ = JM.route(jnp.asarray(xb), jnp.asarray(w), jc.moe)
    _, tib, _ = TM.route(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(w), tc.moe)
    np.testing.assert_array_equal(tib.numpy(), np.asarray(jib))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_expert_capacity_equals_reference(arch):
    for get in ("get", "get_reduced"):
        jm = getattr(jconfigs, get)(arch).moe
        tm = getattr(tconfigs, get)(arch).moe
        for n in (1, 7, 8, 64, 100, 513, 4096):
            assert TM.expert_capacity(n, tm) == JM.expert_capacity(n, jm)


def _layer_params(jc, seed):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jc, jc.n_layers, jnp.float32)
    return jp, params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("E,k,d,T", MOES)
@pytest.mark.parametrize("li", [0, 1])
def test_moe_ffn_dropless_matches_reference(E, k, d, T, li):
    jc, tc = _moe_cfgs(E, k, d)
    jp, tp = _layer_params(jc, E + li)
    x = np.random.default_rng(T).standard_normal((3, T, d)).astype(np.float32)
    jo, ja = JM.moe_ffn_dropless(jnp.asarray(x), jp, li, jc)
    to, ta = TM.moe_ffn_dropless(torch.from_numpy(x), tp, li, tc)
    assert to.shape == (3, T, d) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)


@pytest.mark.parametrize("E,k,d,T", MOES)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_capacity_matches_reference(E, k, d, T, capacity_factor):
    """Capacity dispatch; at factor 0.5 the busiest experts drop slots."""
    jc, tc = _moe_cfgs(E, k, d)
    jc = jconfig.replace(jc, moe=jconfig.replace(
        jc.moe, capacity_factor=capacity_factor))
    tc = tconfig.replace(tc, moe=tconfig.replace(
        tc.moe, capacity_factor=capacity_factor))
    jp, tp = _layer_params(jc, E)
    x = np.random.default_rng(T + 1).standard_normal((2, T, d)).astype(
        np.float32)
    jo, ja = JM.moe_ffn(jnp.asarray(x), jp, 1, jc)
    to, ta = TM.moe_ffn(torch.from_numpy(x), tp, 1, tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    if capacity_factor < 1:     # some slot was dropped: not the dropless FFN
        full, _ = TM.moe_ffn_dropless(torch.from_numpy(x), tp, 1, tc)
        assert not torch.allclose(full, to)


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("stacked", [False, True])
def test_ffn_picks_the_reference_ffn(dropless, stacked):
    """``moe.ffn``, the one FFN choice of the engine and the serve steps:
    the dropless or the capacity FFN of the reference on h [B, S, d], and
    on a stacked tree's ``[1, L, ...]`` leaves the same as on ``[L,
    ...]`` (f32 2e-5)."""
    jc, tc = _moe_cfgs(32, 8, 64)
    jp, tp = _layer_params(jc, 7)
    x = np.random.default_rng(11).standard_normal((2, 9, 64)).astype(
        np.float32)
    jfn = JM.moe_ffn_dropless if dropless else JM.moe_ffn
    jo, _ = jfn(jnp.asarray(x), jp, 1, jc)
    lp = {k: v[None] for k, v in tp.items()} if stacked else tp
    to = TM.ffn(torch.from_numpy(x), lp, 1, tc, dropless)
    assert to.shape == (2, 9, 64)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_dropless_output_does_not_depend_on_the_batch():
    """A token's dropless output is the same alone and among others."""
    jc, tc = _moe_cfgs(32, 8, 64)
    _, tp = _layer_params(jc, 3)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 9, 64)).astype(np.float32))
    batch, _ = TM.moe_ffn_dropless(x, tp, 0, tc)
    for b, s in ((0, 0), (2, 5), (3, 8)):
        alone, _ = TM.moe_ffn_dropless(x[b:b + 1, s:s + 1], tp, 0, tc)
        np.testing.assert_allclose(alone[0, 0].numpy(), batch[b, s].numpy(),
                                   **TOL)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_trees_match_reference_shapes(arch):
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jinit(jax.random.PRNGKey(0), jc, jnp.bfloat16)
    tp = tinit(tc, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jl) == len(jax.tree_util.tree_leaves(jp))
    for path, leaf in jl:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert (node.dtype == torch.float32) == (leaf.dtype == jnp.float32)
    assert tp["layers"]["router"].dtype == torch.float32
    # the bridge keeps the reference's float32 router in a bf16 tree
    carried = params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                              torch.bfloat16)
    assert carried["layers"]["router"].dtype == torch.float32
    assert carried["layers"]["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-3b-a800m"])
def test_init_params_draws_in_tree_order(arch):
    """One generator draws the embedding, then the attention, then the
    FFN (MLP or MoE): a seed gives the same dense weights as before the
    MoE branch, so the card's seeded phases keep their weights."""
    from repro_torch.models.layers import init_attn, init_embed, init_mlp
    from repro_torch.config import pad_vocab
    cfg = tconfigs.get_reduced(arch)
    tree = tinit(cfg, torch.Generator().manual_seed(4), torch.float32, "cpu")
    g = torch.Generator().manual_seed(4)
    L = cfg.n_layers
    want = {"tok": init_embed(cfg, pad_vocab(cfg.vocab_size), g,
                              torch.float32, "cpu"),
            "layers": {**init_attn(cfg, L, g, torch.float32, "cpu"),
                       **(TM.init_moe(cfg, L, g, torch.float32, "cpu")
                          if cfg.moe else
                          init_mlp(cfg.d_model, cfg.d_ff, L, g,
                                   torch.float32, "cpu"))}}
    for part in ("tok", "layers"):
        for k, v in want[part].items():
            assert torch.equal(tree[part][k], v), (part, k)
