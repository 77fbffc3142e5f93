"""Token sampling in the port (``repro_torch.serving.sampling``) against
the JAX package's ``repro.serving.sampling``: the five tests of
``tests/test_sampling.py`` on the port, greedy equal to the JAX argmax
exactly, and the top-k / top-p masks keeping exactly the tokens the
reference's keep on seeded numpy logits (the reference's masked logits
are read where it hands them to ``jax.random.categorical``).  The draws
come from another random stream, so they match only in distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.serving import sampling as jsampling
from repro_torch.serving.sampling import SamplingConfig, masked_logits, sample


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_masked(monkeypatch, logits: np.ndarray, cfg) -> np.ndarray:
    """The logits the reference's ``sample`` draws from."""
    seen = []
    draw = jax.random.categorical

    def capture(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return draw(key, lg, axis=axis)
    monkeypatch.setattr(jax.random, "categorical", capture)
    jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                     jsampling.SamplingConfig(cfg.temperature, cfg.top_k,
                                              cfg.top_p))
    monkeypatch.setattr(jax.random, "categorical", draw)
    (out,) = seen
    return out


def test_greedy():
    logits = torch.tensor([[0.1, 3.0, -1.0], [2.0, 0.0, 5.0]])
    out = sample(logits, _gen(0), SamplingConfig())
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), [1, 2])


def test_greedy_equals_jax_argmax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((16, 1000)).astype(np.float32)
    logits[3, 10] = logits[3, 11] = logits[3].max() + 1   # a tie: first wins
    want = jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                            jsampling.SamplingConfig())
    got = sample(torch.from_numpy(logits), _gen(0), SamplingConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_masks():
    logits = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    cfg = SamplingConfig(temperature=1.0, top_k=2)
    gen = _gen(0)
    outs = {int(sample(logits, gen, cfg)[0]) for _ in range(64)}
    assert outs <= {2, 3}


def test_top_p_masks():
    logits = torch.tensor([[10.0, 0.0, 0.0, 0.0]])
    cfg = SamplingConfig(temperature=1.0, top_p=0.9)
    gen = _gen(0)
    outs = {int(sample(logits, gen, cfg)[0]) for _ in range(32)}
    assert outs == {0}


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10_000))
def test_sample_in_vocab(seed):
    logits = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((3, 17)).astype(
            np.float32))
    gen = _gen(seed)
    for cfg in (SamplingConfig(), SamplingConfig(temperature=0.7),
                SamplingConfig(temperature=1.0, top_k=5),
                SamplingConfig(temperature=1.0, top_p=0.8)):
        out = sample(logits, gen, cfg)
        assert out.shape == (3,)
        assert ((out >= 0) & (out < 17)).all()


def test_temperature_sharpens():
    logits = torch.tensor([[0.0, 1.0]])
    gen = _gen(0)
    hot = sum(int(sample(logits, gen, SamplingConfig(temperature=5.0))[0])
              for _ in range(200))
    cold = sum(int(sample(logits, gen, SamplingConfig(temperature=0.1))[0])
               for _ in range(200))
    assert cold >= hot


@pytest.mark.parametrize("cfg", [
    SamplingConfig(temperature=1.0, top_k=5),
    SamplingConfig(temperature=0.7, top_k=40),
    SamplingConfig(temperature=1.0, top_p=0.8),
    SamplingConfig(temperature=0.5, top_p=0.95),
    SamplingConfig(temperature=1.3, top_k=20, top_p=0.6),
], ids=["k5", "k40", "p0.8", "p0.95", "k20-p0.6"])
def test_masks_keep_the_reference_set(cfg, monkeypatch):
    """Seeded numpy logits (rounded to a 1/8 grid, so ties at the
    threshold occur): the port's kept tokens are exactly the
    reference's, row by row, and the kept logits equal it within f32."""
    rng = np.random.default_rng(11)
    logits = (np.round(rng.standard_normal((8, 257)) * 8) / 8).astype(
        np.float32)
    want = _jax_masked(monkeypatch, logits, cfg)
    got = masked_logits(torch.from_numpy(logits), cfg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    assert keep.any(axis=1).all() and (~keep).any()
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_draws_follow_the_reference_distribution(monkeypatch):
    """The port's draws land only on the reference's kept tokens, at the
    frequencies of the reference's masked softmax (4,000 draws; each
    frequency within 0.03, about 4 standard deviations)."""
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((1, 64)).astype(np.float32) * 2
    cfg = SamplingConfig(temperature=0.8, top_k=10, top_p=0.9)
    want = _jax_masked(monkeypatch, logits, cfg)[0]
    p = np.exp(want - want[np.isfinite(want)].max())
    p /= p.sum()
    gen = _gen(3)
    draws = torch.cat([sample(torch.from_numpy(logits), gen, cfg)
                       for _ in range(4000)]).numpy()
    freq = np.bincount(draws, minlength=64) / len(draws)
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(p))
    np.testing.assert_allclose(freq, p, atol=0.03)
