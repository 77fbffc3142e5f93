"""The port's serve steps (``repro_torch.launch.steps``) against the
JAX package's (``repro.launch.steps``), on the CPU, at the reduced
qwen2-7b (QKV bias), qwen3-14b (QK-norm), granite-moe-3b-a800m and
qwen3-moe-235b-a22b (MoE; QK-norm) sizes; the SSM (mamba2-2.7b) and
hybrid (zamba2-1.2b, dense and windowed shared-attention caches)
steps, the ring-buffer sliding-window decode and the vlm / audio
``prefix_emb`` prefill at 2e-5 as well; and, in the port alone, prefill
then decode against its ``forward`` for all ten architectures, as
``tests/test_steps.py`` holds the reference.  The MoE steps run the
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

from conftest import ALL_ARCHS

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
    """The W8/KV8 step refuses the SSM and hybrid families, as the JAX
    step does (it asserts an attention family)."""
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        with pytest.raises(NotImplementedError, match="no W8/KV8 step"):
            TS.make_decode_step_w8kv8(tconfigs.get_reduced(arch))
        with pytest.raises(AssertionError):
            JS.make_decode_step_w8kv8(jconfigs.get_reduced(arch))


# ---------------------------------------------------------------------------
# the SSM, hybrid, windowed and prefix steps against the reference's
# ---------------------------------------------------------------------------
def _params(arch, seed=0):
    cfg = jconfigs.get_reduced(arch)
    jp = jinit(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return cfg, jp, params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")


def _ring(cache, W, n):
    """Ring buffers ``[L, B, KV, W, hd]`` holding the first ``n``
    positions of a dense cache ``[L, B, S, KV, hd]`` at slot p % W, as
    the reference test fills them (later positions overwrite)."""
    L, b, _, kv, hd = cache.shape
    ring = np.zeros((L, b, kv, W, hd), np.float32)
    for p in range(n):
        ring[:, :, :, p % W] = cache[:, :, p]
    return ring


def _check(port: dict, ref: dict, keys):
    for key in keys:
        np.testing.assert_allclose(port[key].numpy(), _np(ref[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("arch,windowed", [("mamba2-2.7b", False),
                                           ("zamba2-1.2b", False),
                                           ("zamba2-1.2b", True)])
def test_ssm_and_hybrid_steps_match_reference(arch, windowed):
    """Prefill (rows of different lengths, the length mask) and three
    decode steps fed the reference's greedy token: logits and every
    cache within 2e-5; the port's decode writes its caches in place."""
    cfg, jp, tp = _params(arch)
    tcfg = tconfigs.get_reduced(arch)
    toks, lens = _inputs(cfg)
    jo = JS.make_prefill_step(cfg, moe_dropless=True)(
        jp, jnp.asarray(toks), jnp.asarray(lens))
    to = TS.make_prefill_step(tcfg, moe_dropless=True)(
        tp, _t(toks).long(), _t(lens))
    keys = ["logits", "ssm_state", "conv_tail"] + (
        ["cache_k", "cache_v"] if cfg.family == "hybrid" else [])
    _check(to, jo, keys)
    jc = [jo["ssm_state"], jo["conv_tail"]]
    if cfg.family == "hybrid":
        for key in ("cache_k", "cache_v"):
            c = _np(jo[key])
            if windowed:
                # rows share the ring's fill: the reference test's way
                c = _ring(c, cfg.sliding_window, SP)
            else:
                c = np.concatenate([c, np.zeros(c.shape[:2] + (N_NEW,)
                                                + c.shape[3:], np.float32)],
                                   axis=2)
            jc.append(jnp.asarray(c))
    tc = [_t(a) for a in jc]
    jdec = JS.make_decode_step(cfg, windowed=windowed, moe_dropless=True)
    tdec = TS.make_decode_step(tcfg, windowed=windowed, moe_dropless=True)
    logits = _np(jo["logits"])
    for t in range(N_NEW):
        nxt = logits.argmax(-1).astype(np.int32)
        lens2 = lens + t + 1
        jd = jdec(jp, *jc, jnp.asarray(nxt), jnp.asarray(lens2))
        td = tdec(tp, *tc, _t(nxt).long(), _t(lens2))
        for key, c in zip(keys[1:], tc):
            assert td[key] is c, key                       # in place
        _check(td, jd, keys)
        jc = [jd[k] for k in keys[1:]]
        logits = _np(jd["logits"])


def test_windowed_decode_matches_reference():
    """The attention families' ring-buffer decode (``write_window``,
    ``windowed_decode_attention``) past the window: logits and ring
    buffers within 2e-5."""
    cfg, jp, tp = _params("qwen2-7b")
    W = cfg.sliding_window
    sp = W + 8
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, sp)).astype(np.int32)
    lens = np.full((B,), sp, np.int32)
    jo = JS.make_prefill_step(cfg, window=W)(jp, jnp.asarray(toks),
                                             jnp.asarray(lens))
    to = TS.make_prefill_step(tconfigs.get_reduced("qwen2-7b"), window=W)(
        tp, _t(toks).long(), _t(lens))
    _check(to, jo, ("logits", "cache_k", "cache_v"))
    jc = [jnp.asarray(_ring(_np(jo[k]), W, sp)) for k in ("cache_k",
                                                          "cache_v")]
    tc = [_t(a) for a in jc]
    jdec = JS.make_decode_step(cfg, windowed=True)
    tdec = TS.make_decode_step(tconfigs.get_reduced("qwen2-7b"),
                               windowed=True)
    logits = _np(jo["logits"])
    for t in range(N_NEW):
        nxt = logits.argmax(-1).astype(np.int32)
        lens2 = lens + t + 1
        jd = jdec(jp, *jc, jnp.asarray(nxt), jnp.asarray(lens2))
        td = tdec(tp, *tc, _t(nxt).long(), _t(lens2))
        assert td["wkey"] is tc[0] and td["wval"] is tc[1]
        _check(td, jd, ("logits", "wkey", "wval"))
        jc = [jd["wkey"], jd["wval"]]
        logits = _np(jd["logits"])


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "musicgen-medium"])
def test_prefix_prefill_matches_reference(arch):
    """The vlm / audio prefill with ``prefix_emb``: the embeddings go
    before the tokens, the last-token logits sit at ``lens + n_pre − 1``
    and the caches cover prefix and prompt."""
    cfg, jp, tp = _params(arch)
    toks, lens = _inputs(cfg)
    prefix = np.random.default_rng(5).standard_normal(
        (B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    jo = JS.make_prefill_step(cfg)(jp, jnp.asarray(toks), jnp.asarray(lens),
                                   jnp.asarray(prefix))
    to = TS.make_prefill_step(tconfigs.get_reduced(arch))(
        tp, _t(toks).long(), _t(lens), _t(prefix))
    assert to["cache_k"].shape[2] == SP + cfg.n_prefix_tokens
    _check(to, jo, ("logits", "cache_k", "cache_v"))


# ---------------------------------------------------------------------------
# prefill then decode against the port's forward (tests/test_steps.py)
# ---------------------------------------------------------------------------
def _gen(cfg, params, n_new=4, s_prompt=16, windowed=False, window=None):
    """The reference test's ``_gen`` on the port: prefill, then greedy
    decode steps; returns (sequence, last logits, prefix)."""
    g = torch.Generator().manual_seed(0)
    b = 2
    s_cache = s_prompt + n_new
    toks = torch.randint(0, cfg.vocab_size, (b, s_prompt), generator=g)
    lens = torch.full((b,), s_prompt, dtype=torch.int32)
    prefix = None
    if cfg.frontend_dim:
        prefix = torch.randn((b, cfg.n_prefix_tokens, cfg.frontend_dim),
                             generator=g)
    pre = TS.make_prefill_step(cfg, moe_dropless=True, window=window)
    out = pre(params, toks, lens) if prefix is None else \
        pre(params, toks, lens, prefix)
    dec = TS.make_decode_step(cfg, windowed=windowed, moe_dropless=True)
    seq, logits = toks, out["logits"]
    n_pre = 0 if prefix is None else prefix.shape[1]

    def step(t):
        nxt = logits.argmax(-1)
        return nxt, torch.cat([seq, nxt[:, None]], 1), torch.full(
            (b,), n_pre + s_prompt + t + 1, dtype=torch.int32)

    if cfg.family in TS.ATTENTION_FAMILIES:
        if windowed:
            W = cfg.sliding_window
            ck = torch.from_numpy(_ring(out["cache_k"].numpy(), W,
                                        s_prompt + n_pre))
            cv = torch.from_numpy(_ring(out["cache_v"].numpy(), W,
                                        s_prompt + n_pre))
        else:
            shape = (cfg.n_layers, b, s_cache + n_pre, cfg.n_kv_heads,
                     cfg.hd)
            ck, cv = torch.zeros(shape), torch.zeros(shape)
            ck[:, :, :s_prompt + n_pre] = out["cache_k"]
            cv[:, :, :s_prompt + n_pre] = out["cache_v"]
        caches = (ck, cv)
    elif cfg.family == "ssm":
        caches = (out["ssm_state"], out["conv_tail"])
    else:
        shape = (cfg.n_layers // cfg.attn_every, b, s_cache,
                 cfg.n_kv_heads, cfg.hd)
        ck, cv = torch.zeros(shape), torch.zeros(shape)
        ck[:, :, :s_prompt] = out["cache_k"]
        cv[:, :, :s_prompt] = out["cache_v"]
        caches = (out["ssm_state"], out["conv_tail"], ck, cv)
    for t in range(n_new):
        nxt, seq, lens2 = step(t)
        logits = dec(params, *caches, nxt, lens2)["logits"]
    return seq, logits, prefix


def _port_params(arch, seed=0):
    cfg = tconfigs.get_reduced(arch)
    from repro_torch.models.transformer import init_params
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                            torch.float32, "cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_full_forward(arch):
    from repro_torch.models.transformer import forward
    cfg, params = _port_params(arch)
    seq, logits, prefix = _gen(cfg, params)
    ref, _ = forward(params, cfg, seq, prefix_emb=prefix, remat=False,
                     moe_dropless=True)
    err = float((logits - ref[:, -1]).abs().max())
    assert err < 5e-4, f"{arch}: decode diverges from forward by {err}"
    assert torch.isfinite(logits).all()


def test_windowed_decode_matches_windowed_forward():
    """Ring-buffer sliding-window decode == windowed full attention."""
    from repro_torch.models.transformer import forward
    cfg, params = _port_params("qwen2-7b")
    W = cfg.sliding_window
    seq, logits, _ = _gen(cfg, params, n_new=4, s_prompt=16, windowed=True,
                          window=W)
    ref, _ = forward(params, cfg, seq, remat=False, window=W)
    assert float((logits - ref[:, -1]).abs().max()) < 5e-4


def test_windowed_decode_evicts():
    """With a prompt longer than the window, the ring buffer holds only
    the last W positions: the decode equals the windowed forward and
    differs from the full one."""
    from repro_torch.models.transformer import forward
    cfg, params = _port_params("qwen2-7b", seed=1)
    W = cfg.sliding_window
    seq, logits, _ = _gen(cfg, params, n_new=3, s_prompt=W + 16,
                          windowed=True, window=W)
    ref_w, _ = forward(params, cfg, seq, remat=False, window=W)
    ref_f, _ = forward(params, cfg, seq, remat=False)
    assert float((logits - ref_w[:, -1]).abs().max()) < 5e-4
    assert float((logits - ref_f[:, -1]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS
                                  if not tconfigs.get_reduced(a).frontend_dim])
def test_prefill_respects_lens(arch):
    """Padded positions beyond lens must not change the last-token
    logits (continuous batching mixes lengths in one prefill)."""
    cfg, params = _port_params(arch)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([16, 16], dtype=torch.int32)
    pre = TS.make_prefill_step(cfg, moe_dropless=True)
    o1 = pre(params, toks, lens)
    toks2 = toks.clone()
    toks2[:, 16:] = 1                      # scribble past lens
    o2 = pre(params, toks2, lens)
    assert float((o1["logits"] - o2["logits"]).abs().max()) < 5e-4
