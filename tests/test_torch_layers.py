"""The port's model layers (``repro_torch.models``) against the JAX
package's (``repro.models``), on the CPU, at the reduced sizes.

The same numpy-seeded inputs and the JAX package's own weights (mapped
through ``params_to_torch``) go through both.  Tolerance: float32, rtol
and atol 2e-5 — the bound of ``tests/test_kernels.py::_tol`` — covering
the different summation orders of XLA's and PyTorch's CPU kernels.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import replace
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)


def _cfg(qk_norm=False):
    cfg = jconfigs.get_reduced("qwen2-7b")
    return replace(cfg, qk_norm=True) if qk_norm else cfg


def _trees(cfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = TT.params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), **TOL)


def test_configs_copy_matches_reference():
    for name in ("qwen2-7b",):
        assert asdict(tconfigs.get(name)) == asdict(jconfigs.get(name))
        assert asdict(tconfigs.get_reduced(name)) == \
            asdict(jconfigs.get_reduced(name))
    with pytest.raises(ValueError, match="unknown architecture"):
        tconfigs.get("no-such-model")


def test_params_to_torch_keeps_tree_and_layout():
    cfg = _cfg()
    jp, tp = _trees(cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(np.asarray(leaf), node.numpy())
    # the port's own random init draws the same tree shapes
    rp = TT.init_params(tconfigs.get_reduced("qwen2-7b"),
                        torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert shapes == {k: {kk: tuple(v.shape) for kk, v in sub.items()}
                      for k, sub in rp.items()}


def test_norm_rope_repeat():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    pos = rng.integers(0, 900, (2, 5)).astype(np.int32)
    _close(JL.rms_norm(jnp.asarray(x), jnp.asarray(w)),
           TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)))
    _close(JL.rope_freqs(64, 1e6), TL.rope_freqs(64, 1e6))
    _close(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
           TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6))
    kv = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    _close(JL.repeat_kv(jnp.asarray(kv), 3),
           TL.repeat_kv(torch.from_numpy(kv), 3))


@pytest.mark.parametrize("window,q_offset,sq", [(None, 0, 24), (8, 0, 24),
                                                (None, 10, 6)])
def test_causal_attention(window, q_offset, sq):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, sq, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    _close(JL.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               window=window, q_offset=q_offset),
           TL.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window,
                               q_offset=q_offset))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attn_qkv_mlp_logits(qk_norm):
    cfg = _cfg(qk_norm)
    jp, tp = _trees(cfg, seed=3)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    for li in range(cfg.n_layers):
        jq = JL.attn_qkv(jnp.asarray(x), jp["layers"], li, cfg,
                         jnp.asarray(pos))
        tq = TL.attn_qkv(torch.from_numpy(x), tp["layers"], li, cfg,
                         torch.from_numpy(pos))
        for a, b in zip(jq, tq):
            _close(a, b)
        _close(JL.mlp(jnp.asarray(x), jp["layers"], li),
               TL.mlp(torch.from_numpy(x), tp["layers"], li))
    _close(JL.lm_logits(jnp.asarray(x), jp["tok"], cfg),
           TL.lm_logits(torch.from_numpy(x), tp["tok"], cfg))


def test_model_axis_matches_per_model_calls():
    """A tree stacked on a leading model axis computes, per model, what
    that model's own tree computes (the fused sweeps rely on it)."""
    cfg = _cfg()
    trees = [_trees(cfg, seed=s)[1] for s in (4, 5)]
    stacked = {k: torch.stack([t["layers"][k] for t in trees])
               for k in trees[0]["layers"]}
    tok = {k: torch.stack([t["tok"][k] for t in trees])
           for k in trees[0]["tok"]}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, cfg.d_model))
                         .astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 40, (2, 3, 4)))
    q, k, v = TL.attn_qkv(x, stacked, 1, cfg, pos)
    h = TL.mlp(x, stacked, 0)
    logits = TL.lm_logits(x, tok, cfg)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)))
    emb = TL.embed_tokens(tok["embed"], toks)
    for m, t in enumerate(trees):
        qm, km, vm = TL.attn_qkv(x[m], t["layers"], 1, cfg, pos[m])
        for a, b in ((q[m], qm), (k[m], km), (v[m], vm),
                     (h[m], TL.mlp(x[m], t["layers"], 0)),
                     (logits[m], TL.lm_logits(x[m], t["tok"], cfg)),
                     (emb[m], TL.embed_tokens(t["tok"]["embed"], toks[m]))):
            torch.testing.assert_close(a, b, **TOL)
