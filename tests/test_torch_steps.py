"""The port's serve steps (``repro_torch.launch.steps``) against the
JAX package's (``repro.launch.steps``), on the CPU, at the reduced
qwen2-7b (QKV bias), qwen3-14b (QK-norm), granite-moe-3b-a800m and
qwen3-moe-235b-a22b (MoE; QK-norm) sizes.  The MoE steps run the
capacity FFN by default and the dropless FFN with ``moe_dropless``, as
the reference's.

* ``make_prefill_step`` / ``make_decode_step`` on a float32 tree: logits
  and caches within rtol/atol 2e-5 (summation order of XLA's and
  PyTorch's CPU kernels), rows of different lengths.
* ``make_decode_step_w8kv8`` on the same quantized tree carried across
  with ``params_to_torch``, 3 decode steps fed the reference's greedy
  token.  The step runs in bf16, and XLA and PyTorch round bf16
  products at different places, so the two differ at bf16 level:
  logits within 2e-2 of the reference's largest |logit|, scales within
  2e-2 relative, greedy tokens equal except on near-ties (the reference
  test's rule).  The int8 cache shows where the difference enters:
  layer 0, whose input is the same dequantized embedding in both,
  writes equal int8 entries and scales (the quantizers agree exactly);
  the deeper layers quantize K/V computed from layer 0's bf16 output,
  which the two round differently, so their dequantized entries agree
  within the same 2e-2 of the row's largest magnitude, and their int8
  entries within 2 steps (a K/V difference near 1 % of the row's
  largest value moves an entry by one step beyond its rounding, at any
  magnitude; with XLA's excess precision turned off such entries
  remain).
* Inside the port, the reference test's criterion for W8/KV8 against
  the float decode: max |Δlogit| / max |logit| < 0.1, greedy tokens
  equal except on near-ties.

The reference's W8/KV8 step cannot run a float32 tree that carries QKV
bias (its scan carry is bf16 and the bias promotes it to float32), so
its qwen2-7b parity runs a bf16 tree; the port follows JAX's type
promotion and runs both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as JS
from repro.models.transformer import init_params as jinit
from repro.serving import quantize as JQ
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as TS
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import quantize as TQ

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = 2e-2
MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
ARCHS = ["qwen2-7b", "qwen3-14b"] + MOE_ARCHS
B, SP, N_NEW = 2, 16, 3
SC = SP + N_NEW                      # cache length: not a block multiple


def _np(a):
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(_np(a)))
    return t if dtype is None else t.to(dtype)


def _inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, SP)).astype(np.int32)
    lens = np.array([SP, SP - 5], np.int32)
    return toks, lens


def _near_tie_ok(logits_q, logits_ref):
    """The reference test's greedy rule: same argmax, or the reference's
    gap to the chosen token within 1 % of its logit spread."""
    aq, af = logits_q.argmax(-1), logits_ref.argmax(-1)
    gap = logits_ref.max(-1) - np.take_along_axis(logits_ref, aq[:, None],
                                                  -1)[:, 0]
    spread = logits_ref.max(-1) - logits_ref.min(-1)
    return bool(((aq == af) | (gap <= 0.01 * spread)).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    _prefill_and_decode_parity(arch, dropless=False)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dropless_prefill_and_decode_match_reference(arch):
    _prefill_and_decode_parity(arch, dropless=True)


def _prefill_and_decode_parity(arch, dropless):
    cfg = jconfigs.get_reduced(arch)
    jp = jinit(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks, lens = _inputs(cfg)
    jo = JS.make_prefill_step(cfg, moe_dropless=dropless)(
        jp, jnp.asarray(toks), jnp.asarray(lens))
    to = TS.make_prefill_step(tconfigs.get_reduced(arch),
                              moe_dropless=dropless)(
        tp, _t(toks).long(), _t(lens))
    for key in ("logits", "cache_k", "cache_v"):
        np.testing.assert_allclose(to[key].numpy(), _np(jo[key]), **TOL)

    shape = (cfg.n_layers, B, SC, cfg.n_kv_heads, cfg.hd)
    jk = jnp.zeros(shape).at[:, :, :SP].set(jo["cache_k"])
    jv = jnp.zeros(shape).at[:, :, :SP].set(jo["cache_v"])
    tk, tv = _t(jk), _t(jv)
    jdec = JS.make_decode_step(cfg, moe_dropless=dropless)
    tdec = TS.make_decode_step(tconfigs.get_reduced(arch),
                               moe_dropless=dropless)
    logits = _np(jo["logits"])
    for t in range(N_NEW):
        nxt = logits.argmax(-1).astype(np.int32)
        lens2 = lens + t + 1
        jd = jdec(jp, jk, jv, jnp.asarray(nxt), jnp.asarray(lens2))
        td = tdec(tp, tk, tv, _t(nxt).long(), _t(lens2))
        assert td["cache_k"] is tk and td["cache_v"] is tv     # in place
        jk, jv, logits = jd["cache_k"], jd["cache_v"], _np(jd["logits"])
        np.testing.assert_allclose(td["logits"].numpy(), logits, **TOL)
        np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)


def _quantized_caches(pk, pv, xp):
    """The reference test's int8 caches [L, B, SC, KV, hd] + scales from
    a prefill cache (``xp`` jnp for the reference, the port's
    ``quantize_kv`` for the port)."""
    out = []
    for p in (pk, pv):
        L, b, S, KV, hd = p.shape
        if xp is jnp:
            s = jnp.maximum(jnp.abs(p).max(-1), 1e-8) / 127.0
            q = jnp.clip(jnp.round(p / s[..., None]), -127, 127)
            out.append((jnp.zeros((L, b, SC, KV, hd), jnp.int8)
                        .at[:, :, :S].set(q.astype(jnp.int8)),
                        jnp.zeros((L, b, SC, KV), jnp.float32)
                        .at[:, :, :S].set(s)))
        else:
            q, s = TQ.quantize_kv(p)
            c = torch.zeros((L, b, SC, KV, hd), dtype=torch.int8)
            sc = torch.zeros((L, b, SC, KV))
            c[:, :, :S], sc[:, :, :S] = q, s
            out.append((c, sc))
    (ck, sk), (cv, sv) = out
    return ck, cv, sk, sv


@pytest.mark.parametrize("arch", ARCHS)
def test_w8kv8_step_matches_reference(arch):
    _w8kv8_parity(arch, dropless=False)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dropless_w8kv8_step_matches_reference(arch):
    _w8kv8_parity(arch, dropless=True)


def _w8kv8_parity(arch, dropless):
    cfg = jconfigs.get_reduced(arch)
    # the reference runs a bf16 tree where the QKV bias would promote
    # its bf16 scan carry (see the module docstring)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if cfg.qkv_bias
                else (jnp.float32, torch.float32))
    jp = jinit(jax.random.PRNGKey(0), cfg, jdt)
    jq = JQ.quantize_params(jp)
    tq = params_to_torch(jax.tree_util.tree_map(_np, jq), "cpu", tdt)
    toks, lens = _inputs(cfg)
    jo = JS.make_prefill_step(cfg)(jp, jnp.asarray(toks), jnp.asarray(lens))
    jc = list(_quantized_caches(jo["cache_k"], jo["cache_v"], jnp))
    tc = [_t(a) for a in jc]
    jdec = JS.make_decode_step_w8kv8(cfg, moe_dropless=dropless)
    tdec = TS.make_decode_step_w8kv8(tconfigs.get_reduced(arch),
                                     moe_dropless=dropless)
    logits = _np(jo["logits"])
    for t in range(N_NEW):
        nxt = logits.argmax(-1).astype(np.int32)
        lens2 = lens + t + 1
        jd = jdec(jq, *jc, jnp.asarray(nxt), jnp.asarray(lens2))
        td = tdec(tq, *tc, _t(nxt).long(), _t(lens2))
        jc = [jd[k] for k in ("cache_k", "cache_v", "scale_k", "scale_v")]
        logits = _np(jd["logits"])
        tl = td["logits"].float().numpy()
        assert np.isfinite(tl).all()
        err = np.abs(tl - logits).max()
        assert err <= BF16_TOL * np.abs(logits).max(), (t, err)
        assert _near_tie_ok(tl, logits), t
        for ref, port, rs, ps in zip(jc[:2], tc[:2], jc[2:], tc[2:]):
            ref, rs = np.asarray(ref, np.int32), _np(rs)
            port, ps = port.numpy().astype(np.int32), ps.numpy()
            err = np.abs(rs - ps).max()
            assert err <= BF16_TOL * np.abs(rs).max(), (t, err)
            # layer 0: same input, same int8 entries and scales
            np.testing.assert_array_equal(port[0], ref[0])
            np.testing.assert_array_equal(ps[0], rs[0])
            # deeper layers: bf16-level K/V differences, quantized
            deq_r, deq_p = ref * rs[..., None], port * ps[..., None]
            row_max = np.abs(deq_r).max(-1, keepdims=True)
            assert (np.abs(deq_p - deq_r) <= BF16_TOL * row_max).all(), t
            assert np.abs(ref - port).max() <= 2, t


@pytest.mark.parametrize("arch", ARCHS)
def test_w8kv8_decode_matches_float_decode_in_port(arch):
    """``tests/test_quantize.py::test_w8kv8_decode_matches_bf16`` inside
    the port: small relative logit error, same greedy tokens."""
    cfg = tconfigs.get_reduced(arch)
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    qparams = TQ.quantize_params(params)
    toks, lens = _inputs(cfg)
    lens[:] = SP
    out = TS.make_prefill_step(cfg)(params, _t(toks).long(), _t(lens))
    ck, cv, sk, sv = _quantized_caches(out["cache_k"], out["cache_v"], torch)
    shape = (cfg.n_layers, B, SC, cfg.n_kv_heads, cfg.hd)
    ckf, cvf = torch.zeros(shape), torch.zeros(shape)
    ckf[:, :, :SP], cvf[:, :, :SP] = out["cache_k"], out["cache_v"]
    dec_q = TS.make_decode_step_w8kv8(cfg)
    dec_f = TS.make_decode_step(cfg)
    logits_f = out["logits"]
    for t in range(N_NEW):
        nxt = logits_f.argmax(-1)
        lens2 = torch.full((B,), SP + t + 1, dtype=torch.int32)
        oq = dec_q(qparams, ck, cv, sk, sv, nxt, lens2)
        logits_f = dec_f(params, ckf, cvf, nxt, lens2)["logits"]
        lq = oq["logits"].float()
        rel = float((lq - logits_f).abs().max() / logits_f.abs().max())
        assert rel < 0.1, f"{arch} step {t}: rel err {rel}"
        assert _near_tie_ok(lq.numpy(), logits_f.numpy()), t


def test_decode_writes_in_place_and_drops_out_of_range_positions():
    """A row whose position lies past the cache leaves the cache as it
    was (JAX's scatter drops it); the other row's token lands at
    ``lens - 1``; the step returns the caches it was given."""
    cfg = tconfigs.get_reduced("qwen2-7b")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         torch.float32, "cpu")
    qparams = TQ.quantize_params(params)
    S = 8
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    g = torch.Generator().manual_seed(2)
    ck = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    cv, sk, sv = ck.clone(), torch.rand(shape[:-1]), torch.rand(shape[:-1])
    before = [a.clone() for a in (ck, cv, sk, sv)]
    lens = torch.tensor([5, S + 1], dtype=torch.int32)
    out = TS.make_decode_step_w8kv8(cfg)(qparams, ck, cv, sk, sv,
                                         torch.tensor([3, 4]), lens)
    assert out["cache_k"] is ck and out["scale_v"] is sv
    for new, old in zip((ck, cv, sk, sv), before):
        assert torch.equal(new[:, 1], old[:, 1])            # dropped row
        changed = (new[:, 0] != old[:, 0]).reshape(
            cfg.n_layers, S, -1).any(-1).any(0)
        assert changed.tolist() == [t == 4 for t in range(S)]

    fk = torch.randn(shape, generator=g)
    fv, fk0 = fk.clone(), fk.clone()
    TS.make_decode_step(cfg)(params, fk, fv, torch.tensor([3, 4]), lens)
    assert torch.equal(fk[:, 1], fk0[:, 1])
    assert not torch.equal(fk[:, 0, 4], fk0[:, 0, 4])


def test_unported_branches_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        TS.make_prefill_step(tconfigs.get_reduced("mamba2-2.7b"))
    with pytest.raises(NotImplementedError, match="not ported"):
        TS.make_decode_step_w8kv8(tconfigs.get_reduced("zamba2-1.2b"))
    with pytest.raises(NotImplementedError, match="sliding-window"):
        TS.make_decode_step(tconfigs.get_reduced("qwen2-7b"), windowed=True)
