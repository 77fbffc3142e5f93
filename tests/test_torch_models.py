"""The port's training forward (``repro_torch.models.transformer``:
``embed_inputs``, ``forward``, ``cross_entropy``, ``loss_fn``) and
``models/registry.py`` against the JAX package's, on the CPU, at the
reduced configs of all ten architectures, weights from the reference's
``init_params`` carried across with ``params_to_torch``.

Tolerances: logits within 1e-4 absolute (the reference's
``blocked_causal_attention`` is ``causal_attention`` at these lengths,
XLA and PyTorch sum in other orders), ``loss_fn`` within 1e-5
relative; gradients of every leaf within 1e-4 of the leaf's largest
reference gradient.  The model properties of ``tests/test_models.py``
(causality, the sliding window, the MoE aux loss) are held in the port
as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.models import registry
from repro_torch.models import transformer as TT

from conftest import ALL_ARCHS

torch.set_num_threads(2)
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 32


def _params(cfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jp, TT.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")


def _batch(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)],
                            axis=1)
    labels[0, :3] = -100                         # masked positions
    prefix = None
    if cfg.frontend_dim:
        prefix = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    return toks, labels, prefix


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    if a is None:
        return None
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg = jconfigs.get_reduced(arch)
    tcfg = tconfigs.get_reduced(arch)
    jp, tp = _params(cfg)
    toks, labels, prefix = _batch(cfg)
    jl, ja = JT.forward(jp, cfg, _j(toks), _j(prefix), remat=False)
    with torch.no_grad():
        tl, ta = TT.forward(tp, tcfg, _t(toks), _t(prefix), remat=False)
    n_pre = 0 if prefix is None else cfg.n_prefix_tokens
    assert tl.shape == (B, S + n_pre, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=LOSS_RTOL, atol=0)
    jloss = float(JT.loss_fn(jp, cfg, _j(toks), _j(labels), _j(prefix)))
    with torch.no_grad():
        tloss = float(TT.loss_fn(tp, tcfg, _t(toks), _t(labels), _t(prefix)))
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_dropless_forward_matches_reference(arch):
    cfg = jconfigs.get_reduced(arch)
    jp, tp = _params(cfg)
    toks, _, _ = _batch(cfg)
    jl, ja = JT.forward(jp, cfg, _j(toks), remat=False, moe_dropless=True)
    with torch.no_grad():
        tl, ta = TT.forward(tp, tconfigs.get_reduced(arch), _t(toks),
                            remat=False, moe_dropless=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch,window", [("qwen2-7b", 16),
                                         ("zamba2-1.2b", 24)])
def test_windowed_forward_matches_reference(arch, window):
    cfg = jconfigs.get_reduced(arch)
    jp, tp = _params(cfg)
    toks, _, _ = _batch(cfg, s=64)
    jl, _ = JT.forward(jp, cfg, _j(toks), remat=False, window=window)
    with torch.no_grad():
        tl, _ = TT.forward(tp, tconfigs.get_reduced(arch), _t(toks),
                           remat=False, window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_gradients_match_reference(arch):
    """Every leaf's gradient of ``loss_fn`` (remat on, as the train
    step's default) against ``jax.grad`` of the reference's, within
    1e-4 of the leaf's largest reference gradient."""
    cfg = jconfigs.get_reduced(arch)
    jp, tp = _params(cfg)
    toks, labels, prefix = _batch(cfg)
    jg = jax.grad(lambda p: JT.loss_fn(p, cfg, _j(toks), _j(labels),
                                       _j(prefix)))(jp)
    names, leaves = zip(*_leaves(tp))
    for t in leaves:
        t.requires_grad_()
    loss = TT.loss_fn(tp, tconfigs.get_reduced(arch), _t(toks), _t(labels),
                      _t(prefix), remat=True)
    tg = torch.autograd.grad(loss, leaves)
    jflat = dict(_leaves(jax.tree_util.tree_map(np.asarray, jg)))
    assert sorted(jflat) == sorted(names)
    for name, g in zip(names, tg):
        ref = jflat[name]
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= GRAD_TOL * scale, (arch, name, err, scale)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-1.2b",
                                  "mamba2-2.7b"])
def test_remat_gives_the_same_gradients(arch):
    """``remat`` recomputes each layer (each group, for the hybrid) in
    the backward: the loss and every gradient equal the un-checkpointed
    run's."""
    cfg = tconfigs.get_reduced(arch)
    _, tp = _params(jconfigs.get_reduced(arch))
    toks, labels, prefix = _batch(cfg)
    names, leaves = zip(*_leaves(tp))
    for t in leaves:
        t.requires_grad_()
    out = []
    for remat in (False, True):
        loss = TT.loss_fn(tp, cfg, _t(toks), _t(labels), _t(prefix),
                          remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for name, a, b in zip(names, g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


def test_loss_keeps_the_padded_vocabulary():
    """The reference's ``loss_fn`` takes the log-sum-exp over
    ``pad_vocab(V)`` columns: so does the port's, and slicing first
    would give another loss."""
    jcfg = jconfigs.get_reduced("qwen2-7b")
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "vocab_size": 500})
    tcfg = tconfig.replace(tconfigs.get_reduced("qwen2-7b"), vocab_size=500)
    assert tconfig.pad_vocab(500) == 512
    jp, tp = _params(jcfg)
    toks, labels, _ = _batch(jcfg)
    jloss = float(JT.loss_fn(jp, jcfg, _j(toks), _j(labels)))
    with torch.no_grad():
        tloss = float(TT.loss_fn(tp, tcfg, _t(toks), _t(labels)))
        sliced, _ = TT.forward(tp, tcfg, _t(toks), remat=False)
        sliced_loss = float(TT.cross_entropy(sliced, _t(labels)))
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss)
    assert abs(sliced_loss - tloss) > 1e-3


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    labels[1, 2:] = -100
    ref = float(JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(TT.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels)))
    assert abs(got - ref) <= 1e-6 * abs(ref)
    none = np.full_like(labels, -100)
    assert float(TT.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(none))) == 0.0


def test_embed_inputs_prepends_the_prefix():
    cfg = tconfigs.get_reduced("phi-3-vision-4.2b")
    jcfg = jconfigs.get_reduced("phi-3-vision-4.2b")
    jp, tp = _params(jcfg)
    toks, _, prefix = _batch(jcfg)
    ref = np.asarray(JT.embed_inputs(jp, jcfg, _j(toks), _j(prefix)))
    got = TT.embed_inputs(tp, cfg, _t(toks), _t(prefix))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape == (B, cfg.n_prefix_tokens + S, cfg.d_model)


# -- the model properties of tests/test_models.py, in the port --------------
def _port_model(arch, seed=0):
    cfg = tconfigs.get_reduced(arch)
    return cfg, TT.init_params(cfg, torch.Generator().manual_seed(seed),
                               torch.float32, "cpu")


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "mamba2-2.7b",
                                  "zamba2-1.2b"])
def test_forward_causality(arch):
    """Future tokens must not leak into earlier logits."""
    cfg, params = _port_model(arch)
    toks = torch.randint(0, cfg.vocab_size, (1, 16),
                         generator=torch.Generator().manual_seed(1))
    toks2 = toks.clone()
    toks2[:, 10:] = (toks2[:, 10:] + 7) % cfg.vocab_size
    with torch.no_grad():
        l1, _ = TT.forward(params, cfg, toks, remat=False)
        l2, _ = TT.forward(params, cfg, toks2, remat=False)
    torch.testing.assert_close(l1[:, :10], l2[:, :10], rtol=0, atol=1e-4)
    assert (l1[:, 10:] - l2[:, 10:]).abs().max() > 1e-3


def test_moe_aux_loss_nonzero():
    cfg, params = _port_model("granite-moe-3b-a800m")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, aux = TT.forward(params, cfg, toks, remat=False)
    assert float(aux) > 0, "load-balance loss must be active"


def test_sliding_window_restricts_context():
    cfg, params = _port_model("qwen2-7b")
    S_, W = 96, 16
    toks = torch.randint(0, cfg.vocab_size, (1, S_),
                         generator=torch.Generator().manual_seed(2))
    toks2 = toks.clone()
    toks2[:, 10] = (toks2[:, 10] + 3) % cfg.vocab_size
    with torch.no_grad():
        lw, _ = TT.forward(params, cfg, toks, remat=False, window=W)
        lw2, _ = TT.forward(params, cfg, toks2, remat=False, window=W)
        lf, _ = TT.forward(params, cfg, toks, remat=False)
    torch.testing.assert_close(lw[:, -1], lw2[:, -1], rtol=0, atol=1e-4)
    assert float((lf[:, -1] - lw[:, -1]).abs().max()) > 1e-3, \
        "window must actually change full-attention outputs"


def test_registry_matches_reference():
    from repro.models import registry as JR
    assert registry.list_archs() == list(JR.list_archs())
    for arch in ALL_ARCHS:
        assert registry.get_config(arch) == tconfigs.get(arch)
        assert registry.get_reduced_config(arch).name == \
            JR.get_reduced_config(arch).name
    cfg = registry.get_reduced_config("qwen2-7b")
    params = registry.init(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        logits, aux = registry.forward(params, cfg, toks, remat=False)
    assert logits.shape == (1, 4, cfg.vocab_size) and float(aux) == 0.0
