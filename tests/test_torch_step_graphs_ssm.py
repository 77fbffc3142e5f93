"""The compiled serving steps (``serving/graphs.py``) of the dense
family's whole-prompt prefill and of the SSM and hybrid families, on the
CPU (reduced qwen2-7b, mamba2-2.7b and zamba2-1.2b, float32, weights from
the JAX package's ``init_params`` carried across with
``params_to_torch``).

* Each fixed-shape body — ``prefill``, ``prefill_ssm``, ``chunk_ssm``
  and ``decode_ssm`` — against the port's eager step as it was before
  the split (its code kept below, with the engine's gather, scatter and
  fresh-row zeroing around it) bit for bit: logits, the engine's state
  buffers (every slot) and every arena row; and against the JAX
  package's ``_prefill_impl`` / ``_prefill_chunk_ssm_impl`` /
  ``_decode_impl``: the arena entries each package leaves untouched are
  the same and untouched bit for bit, logits, new SSM state, conv tail
  and written entries agree within 2e-5.  The cases cover padded
  prefill rows with −1 tables, a step that keeps no write, fresh and
  carried chunk rows, a decode past its table and the hybrid's
  attention layers.
* The registry, through the capture stub of ``test_torch_step_graphs``:
  one program per bucket and kind, recaptures after crash recovery's
  fresh engine and after a reallocating ``grow`` for the kinds that read
  the arena, none for the pure-SSM steps, rollbacks under a tight quota
  with the eager run's tokens and reports and every rolled-back row's
  pre-step state, and ``chip_smoke.serve_graph_steps`` rehearsed at
  reduced width.
"""
import contextlib
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.transformer import init_params as jinit
from repro.serving import engine as JE
from repro_torch import configs
from repro_torch.core.workload import synthesize
from repro_torch.models import mamba2 as M2
from repro_torch.models.layers import (attn_qkv, embed_tokens, linear,
                                       lm_logits, mlp, rms_norm)
from repro_torch.models.moe import ffn
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import cache_ops, driver, graphs
from repro_torch.serving import engine as TE
from repro_torch.serving.kvcache import UnifiedKVPool

from test_torch_step_graphs import RecordingCapture

torch.set_num_threads(2)

N_BLOCKS = 256           # arena head-blocks of the body tests
W = 4                    # table width of the body tests (64 tokens a row)
SLOTS = 6                # state slots of the body tests' engine buffers
TOL = 2e-5
_to = TE._to


# ---------------------------------------------------------------------------
# the port's steps before the split
# ---------------------------------------------------------------------------
def _old_prefill_step(params, midx, toks, lens, pool, table, *, cfg):
    """Whole-prompt prefill of one model: dense causal attention over
    the prompt (the flash-prefill kernel on CUDA), KV written into the
    pool, logits at each row's last prompt token.

    toks: [B, S] (S a block multiple); lens: [B]; table: [B, W]
    Returns logits [B, vocab].
    """
    B, S = toks.shape
    dev = pool.device
    p = TE._select_model(params, midx)
    lp = p["layers"]
    n_kv, hd = cfg.n_kv_heads, cfg.hd
    slots = cache_ops.token_slots(table, np.zeros(B, np.int64), S,
                                  pool.block_tokens, dev)
    positions = torch.arange(S, device=dev).expand(1, B, S)
    x = embed_tokens(p["tok"]["embed"], _to(dev, toks, torch.int64)[None])
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h, lp, li, cfg, positions)      # [1,B,S,{H,KV},hd]
        o = cache_ops.flash_prefill(q[0].contiguous(), k[0].contiguous(),
                                    v[0].contiguous())
        cache_ops.write_slots(pool.k, pool.v, k[0], v[0], slots, li, n_kv)
        x = x + linear(o.reshape(1, B, S, -1), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    idx = _to(dev, np.maximum(lens - 1, 0), torch.int64)
    x_last = x[0, torch.arange(B, device=dev), idx]              # [B, d]
    return lm_logits(x_last[None], p["tok"], cfg)[0, :, :cfg.vocab_size]


def _old_prefill_ssm_step(params, midx, toks, lens, pool, table, *, cfg):
    """Whole-prompt prefill of an SSM or hybrid model: the mixer over
    the prompt (the SSD kernel on CUDA) with padded positions masked,
    and for hybrid the shared attention block after every
    ``attn_every`` layers (the flash-prefill kernel on CUDA; KV written
    into the pool at attention-layer index ``attn_li``).  Like the JAX
    package's engine, the hybrid path ignores ``sliding_window``.

    toks: [B, S] (S a block multiple); lens: [B]; table: [B, W]
    Returns (logits [B, vocab], ssm_state [L, B, H, P, N] f32,
    conv_tail [L, B, K-1, conv_dim]).
    """
    B, S = toks.shape
    dev = pool.device
    p = TE._one_model(params, midx)
    lp = p["layers"]
    x = embed_tokens(p["tok"]["embed"], _to(dev, toks, torch.int64))
    lens_t = _to(dev, lens, torch.int64)
    mask = torch.arange(S, device=dev)[None, :] < lens_t[:, None]
    sc = cfg.ssm
    new_ssm = torch.empty((cfg.n_layers, B, cfg.n_ssm_heads, sc.head_dim,
                           sc.d_state), dtype=torch.float32, device=dev)
    new_tail = torch.empty((cfg.n_layers, B, sc.conv_kernel - 1,
                            cfg.d_inner + 2 * sc.n_groups * sc.d_state),
                           dtype=x.dtype, device=dev)
    if cfg.family == "hybrid":
        slots = cache_ops.token_slots(table, np.zeros(B, np.int64), S,
                                      pool.block_tokens, dev)
        positions = torch.arange(S, device=dev).expand(B, S)
        sa = p["shared_attn"]
    attn_li = 0
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, new_ssm[li], new_tail[li] = M2.mamba2_mixer(
            h, lp, li, cfg, return_cache=True, length_mask=mask)
        x = x + out
        if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
            h = rms_norm(x, sa["ln1"][0], cfg.rms_eps)
            q, k, v = attn_qkv(h, sa, 0, cfg, positions)   # [B,S,{H,KV},hd]
            o = cache_ops.flash_prefill(q.contiguous(), k.contiguous(),
                                        v.contiguous())
            cache_ops.write_slots(pool.k, pool.v, k, v, slots, attn_li,
                                  cfg.n_kv_heads)
            attn_li += 1
            x = x + linear(o.reshape(B, S, -1), sa["wo"][0])
            x = x + mlp(rms_norm(x, sa["ln2"][0], cfg.rms_eps), sa, 0)
    idx = _to(dev, np.maximum(lens - 1, 0), torch.int64)
    x_last = x[torch.arange(B, device=dev), idx]                 # [B, d]
    logits = lm_logits(x_last, p["tok"], cfg)[:, :cfg.vocab_size]
    return logits, new_ssm, new_tail


def _old_prefill_chunk_ssm_step(params, midx, toks, clens, ssm_state,
                                conv_tail, *, cfg):
    """Chunked prefill of a pure-SSM model: the mixer's conv-tail +
    state carry IS the chunk boundary.  ``clens`` masks padded chunk
    positions (dt=0 ⇒ state frozen past the true chunk length).

    toks: [B, C]; clens: [B]; ssm_state / conv_tail: the rows' carried
    caches.  Returns (logits [B, vocab], new ssm_state, new conv_tail).
    """
    B, C = toks.shape
    dev = ssm_state.device
    p = TE._one_model(params, midx)
    lp = p["layers"]
    x = embed_tokens(p["tok"]["embed"], _to(dev, toks, torch.int64))
    clens_t = _to(dev, clens, torch.int64)
    mask = torch.arange(C, device=dev)[None, :] < clens_t[:, None]
    new_ssm, new_tail = torch.empty_like(ssm_state), torch.empty_like(
        conv_tail)
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, new_ssm[li], new_tail[li] = M2.mamba2_mixer(
            h, lp, li, cfg, conv_tail=conv_tail[li], ssm_state=ssm_state[li],
            return_cache=True, length_mask=mask)
        x = x + out
    x_last = x[torch.arange(B, device=dev), (clens_t - 1).clamp(min=0)]
    logits = lm_logits(x_last, p["tok"], cfg)[:, :cfg.vocab_size]
    return logits, new_ssm, new_tail


def _old_decode_ssm_step(params, midx, last_tok, lens, pool, table,
                         ssm_state, conv_tail, *, cfg):
    """One decode step of an SSM or hybrid model: ``mamba2_decode_step``
    per layer and, for hybrid, the shared attention block over the pool
    (the paged-decode kernel on CUDA) after every ``attn_every``
    layers.  last_tok, lens [B] (lens incl. the current token, whose
    position is lens−1); table [B, W]; ssm_state / conv_tail the rows'
    caches.  Returns (logits [B, vocab], new ssm_state, new conv_tail).
    """
    B = last_tok.shape[0]
    dev = ssm_state.device
    p = TE._one_model(params, midx)
    lp = p["layers"]
    x = embed_tokens(p["tok"]["embed"], _to(dev, last_tok, torch.int64))
    new_ssm, new_tail = torch.empty_like(ssm_state), torch.empty_like(
        conv_tail)
    if cfg.family == "hybrid":
        pos = lens.astype(np.int64) - 1
        slots = cache_ops.token_slots(table, pos, 1, pool.block_tokens, dev)
        table_t = _to(dev, table)
        lens_t = _to(dev, lens, torch.int32)
        pos_t = _to(dev, pos)[:, None]                              # [B, 1]
        sa = p["shared_attn"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn_li = 0
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, new_tail[li], new_ssm[li] = M2.mamba2_decode_step(
            h, lp, li, cfg, conv_tail[li], ssm_state[li])
        x = x + out
        if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
            h = rms_norm(x, sa["ln1"][0], cfg.rms_eps)
            q, k, v = attn_qkv(h[:, None, :], sa, 0, cfg, pos_t)
            cache_ops.write_slots(pool.k, pool.v, k, v, slots, attn_li, n_kv)
            phys = cache_ops.resolve_physical_blocks(table_t, attn_li, n_kv)
            o = cache_ops.fused_paged_decode_attention(
                q.reshape(B, n_h, hd).contiguous(), pool.k, pool.v, phys,
                lens_t)
            attn_li += 1
            x = x + linear(o.reshape(B, n_h * hd), sa["wo"][0])
            x = x + mlp(rms_norm(x, sa["ln2"][0], cfg.rms_eps), sa, 0)
    logits = lm_logits(x, p["tok"], cfg)[:, :cfg.vocab_size]
    return logits, new_ssm, new_tail


# ---------------------------------------------------------------------------
# the bodies against the old port steps and the JAX steps
# ---------------------------------------------------------------------------
ARCHS = ("qwen2-7b", "mamba2-2.7b", "zamba2-1.2b")


def _stack(trees):
    """The port's trees stacked on a leading model axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_reduced(arch)
        trees = [jax.tree_util.tree_map(np.asarray, jinit(
            jax.random.PRNGKey(i), jcfg, jnp.float32)) for i in range(2)]
        jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *trees)
        out[arch] = (jcfg, jstack,
                     _stack([params_to_torch(t, "cpu") for t in trees]))
    return out


def _inputs(kind: str, arch: str, case: str, seed: int) -> dict:
    """One step's host arrays.  ``prefill``/``prefill_ssm``: four rows
    of 32 tokens, the last a padded row (−1 table, length 0), row 1's
    table cut after its first block, real rows in slots [4, 1, 3];
    ``none``: every table −1 (no write).  ``chunk_ssm``: three 16-token
    chunk rows in slots [5, 0, 2] of 16, 9 and 1 tokens; ``fresh``: rows
    0 and 2 start from zero state.  ``decode_ssm``: three rows in slots
    [3, 0, 5]; ``past``: row 0 at position 16·W, past its table."""
    rng = np.random.default_rng(seed)
    cfg = configs.get_reduced(arch)
    gs = max(cfg.n_attn_layers * cfg.n_kv_heads, 1)
    B = 4 if kind.startswith("prefill") else 3
    table = (rng.permutation(N_BLOCKS // gs)[:B * W] * gs).reshape(
        B, W).astype(np.int32)
    a = dict(table=table)
    if kind.startswith("prefill"):
        lens = np.array([32, 20, 7, 0], np.int32)
        toks = rng.integers(1, cfg.vocab_size, (B, 32)).astype(np.int32)
        toks[np.arange(32)[None, :] >= lens[:, None]] = 0
        table[-1] = -1
        table[1, 1:] = -1
        a.update(toks=toks, lens=lens, slots=[4, 1, 3])
    elif kind == "chunk_ssm":
        clens = np.array([16, 9, 1], np.int32)
        toks = rng.integers(1, cfg.vocab_size, (B, 16)).astype(np.int32)
        toks[np.arange(16)[None, :] >= clens[:, None]] = 0
        a.update(toks=toks, clens=clens, slots=[5, 0, 2],
                 fresh=np.array([case == "fresh", False, case == "fresh"]))
    else:
        lens = np.array([20, 33, 5], np.int32)
        if case == "past":
            lens[0] = 16 * W + 1
        a.update(toks=rng.integers(1, cfg.vocab_size, B).astype(np.int32),
                 lens=lens, slots=[3, 0, 5])
    if case == "none":
        table[:] = -1
    return a


def _arena(seed: int):
    rng = np.random.default_rng(100 + seed)
    shape = (N_BLOCKS, 16, 64)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _state(cfg, seed: int):
    """Random contents of an engine's ``SLOTS``-slot state buffers."""
    rng = np.random.default_rng(200 + seed)
    sc = cfg.ssm
    conv_dim = cfg.d_inner + 2 * sc.n_groups * sc.d_state
    return ((0.1 * rng.standard_normal((cfg.n_layers, SLOTS, cfg.n_ssm_heads,
                                        sc.head_dim, sc.d_state))
             ).astype(np.float32),
            rng.standard_normal((cfg.n_layers, SLOTS, sc.conv_kernel - 1,
                                 conv_dim)).astype(np.float32))


def _port_pool(pk, pv):
    pool = UnifiedKVPool(N_BLOCKS, pk.shape[-1], torch.float32, device="cpu")
    pool.k.copy_(torch.from_numpy(pk))
    pool.v.copy_(torch.from_numpy(pv))
    return pool


def _numpy(*ts):
    return tuple(t.numpy().copy() for t in ts)


CASES = [("prefill", "qwen2-7b", "padded"), ("prefill", "qwen2-7b", "none"),
         ("prefill_ssm", "mamba2-2.7b", "padded"),
         ("prefill_ssm", "zamba2-1.2b", "padded"),
         ("prefill_ssm", "zamba2-1.2b", "none"),
         ("chunk_ssm", "mamba2-2.7b", "fresh"),
         ("chunk_ssm", "mamba2-2.7b", "carried"),
         ("decode_ssm", "mamba2-2.7b", "rows"),
         ("decode_ssm", "zamba2-1.2b", "rows"),
         ("decode_ssm", "zamba2-1.2b", "past")]


def _run_three(kind, arch, case, weights):
    """(new port step, old port step, JAX step) on the same inputs, each a
    dict of numpy arrays: ``logits``, ``k`` / ``v`` arenas and, for the
    SSM kinds, the engine's ``ssm`` / ``tail`` buffers (the JAX step's
    rows written into a copy of them)."""
    jcfg, jstack, tstack = weights[arch]
    cfg = configs.get_reduced(arch)
    seed = CASES.index((kind, arch, case))
    a = _inputs(kind, arch, case, seed)
    pk, pv = _arena(seed)
    st0, tail0 = _state(cfg, seed) if cfg.ssm else (None, None)
    slots = a.get("slots")
    n = len(slots) if slots else 0
    midx = 1
    res = {}
    for which in ("new", "old"):
        pool = _port_pool(pk, pv)
        ssm = tail = None
        if cfg.ssm:
            ssm, tail = torch.from_numpy(st0.copy()), torch.from_numpy(
                tail0.copy())
        sl = torch.tensor(slots) if slots else None
        if kind == "prefill":
            fn = TE._prefill_step if which == "new" else _old_prefill_step
            lg = fn(tstack, midx, a["toks"], a["lens"], pool, a["table"],
                    cfg=cfg)
        elif kind == "prefill_ssm" and which == "new":
            lg = TE._prefill_ssm_step(tstack, midx, a["toks"], a["lens"],
                                      pool, a["table"], cfg=cfg,
                                      state=(ssm, tail), slots=slots)
        elif kind == "prefill_ssm":
            lg, ns, nt = _old_prefill_ssm_step(tstack, midx, a["toks"],
                                               a["lens"], pool, a["table"],
                                               cfg=cfg)
            ssm[:, sl] = ns[:, :n]
            tail[:, sl] = nt[:, :n].to(tail.dtype)
        elif kind == "chunk_ssm" and which == "new":
            lg = TE._prefill_chunk_ssm_step(
                tstack, midx, a["toks"], a["clens"], ssm, tail, cfg=cfg,
                slots=slots, fresh=a["fresh"])
        elif kind == "chunk_ssm":
            st, tl = ssm[:, sl], tail[:, sl]
            fr = torch.from_numpy(a["fresh"])
            st[:, fr] = 0
            tl[:, fr] = 0
            lg, ns, nt = _old_prefill_chunk_ssm_step(
                tstack, midx, a["toks"], a["clens"], st, tl, cfg=cfg)
            ssm[:, sl] = ns
            tail[:, sl] = nt.to(tail.dtype)
        elif which == "new":
            prev = (torch.full_like(ssm, float("nan")),
                    torch.full_like(tail, float("nan")))
            lg = TE._decode_ssm_step(tstack, midx, a["toks"], a["lens"],
                                     pool, a["table"], ssm, tail, cfg=cfg,
                                     slots=slots, prev=prev)
            res["prev"] = _numpy(prev[0][:, :n], prev[1][:, :n])
        else:
            prev_ssm, prev_tail = ssm[:, sl], tail[:, sl]
            lg, ns, nt = _old_decode_ssm_step(
                tstack, midx, a["toks"], a["lens"], pool, a["table"],
                prev_ssm, prev_tail, cfg=cfg)
            ssm[:, sl] = ns
            tail[:, sl] = nt.to(tail.dtype)
        res[which] = dict(zip(("logits", "k", "v"),
                              _numpy(lg, pool.k, pool.v)))
        if cfg.ssm:
            res[which].update(ssm=ssm.numpy(), tail=tail.numpy())
    # the JAX step on the rows' state
    j = {k: jnp.asarray(x) for k, x in a.items() if k != "slots"}
    jpk, jpv = jnp.asarray(pk), jnp.asarray(pv)
    if cfg.ssm:
        rows_st, rows_tail = st0[:, slots], tail0[:, slots]
        if kind == "chunk_ssm":
            rows_st[:, a["fresh"]] = 0
            rows_tail[:, a["fresh"]] = 0
    if kind in ("prefill", "prefill_ssm"):
        jk, jv, jl, js, jt = JE._prefill_impl(jstack, midx, j["toks"],
                                              j["lens"], jpk, jpv,
                                              j["table"], cfg=jcfg)
    elif kind == "chunk_ssm":
        jl, js, jt = JE._prefill_chunk_ssm_impl(
            jstack, midx, j["toks"], j["clens"], jnp.asarray(rows_st),
            jnp.asarray(rows_tail), cfg=jcfg)
        jk, jv = jpk, jpv
    else:
        jk, jv, jl, js, jt = JE._decode_impl(
            jstack, midx, j["toks"], j["lens"], jpk, jpv, j["table"],
            jnp.asarray(rows_st), jnp.asarray(rows_tail), cfg=jcfg)
    res["jax"] = dict(logits=np.asarray(jl), k=np.asarray(jk),
                      v=np.asarray(jv))
    if cfg.ssm:
        ssm, tail = st0.copy(), tail0.copy()
        ssm[:, slots] = np.asarray(js)[:, :n]
        tail[:, slots] = np.asarray(jt)[:, :n]
        res["jax"].update(ssm=ssm, tail=tail)
    res["before"] = dict(k=pk, v=pv, ssm=st0, tail=tail0)
    res["slots"] = slots
    return res


@pytest.mark.parametrize("kind,arch,case", CASES)
def test_fixed_shape_body_matches_old_step_and_reference(kind, arch, case,
                                                         weights):
    res = _run_three(kind, arch, case, weights)
    new, old, ref, before = res["new"], res["old"], res["jax"], res["before"]
    # against the port's eager step before the split: bit for bit
    assert new.keys() == old.keys()
    for name in new:
        np.testing.assert_array_equal(new[name], old[name], err_msg=name)
    # against the JAX step: the same entries written, the rest untouched
    for name in new:
        got, want, was = new[name], ref[name], before.get(name)
        if was is not None:
            # an entry: a token's head-block row, or a layer's slot
            per = -1 if name in ("k", "v") else tuple(range(2, got.ndim))
            wrote, wrote_ref = (got != was).any(axis=per), \
                (want != was).any(axis=per)
            np.testing.assert_array_equal(wrote, wrote_ref, err_msg=name)
            np.testing.assert_array_equal(got[~wrote], was[~wrote],
                                          err_msg=name)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=name)
    if case == "none":
        for name in ("k", "v"):
            np.testing.assert_array_equal(new[name], before[name])
    if "prev" in res:
        # the rollback's copy holds the rows' pre-step state
        np.testing.assert_array_equal(res["prev"][0],
                                      before["ssm"][:, res["slots"]])
        np.testing.assert_array_equal(res["prev"][1],
                                      before["tail"][:, res["slots"]])


# ---------------------------------------------------------------------------
# the registry, through the capture stub
# ---------------------------------------------------------------------------
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


MIXED = ("qwen2-7b", "mamba2-2.7b", "zamba2-1.2b")


def _mixed_unit(chunk: int, pool_blocks: int = 4000, archs=MIXED,
                mean_output: int = 8):
    names = [f"llm{i}" for i in range(len(archs))]
    wl = synthesize(names, alpha=1.0, max_rate=12.0, horizon=1.0, seed=0,
                    mean_prompt=24, mean_output=mean_output, max_len=48)
    unit = driver.build_unit_from_specs(
        [(n, a, wl.rates[n]) for n, a in zip(names, archs)],
        pool_blocks=pool_blocks, max_slots=4, chunk_tokens=chunk,
        policy="adbs", fused=True, dtype=torch.float32, device="cpu")
    return unit, driver.requests_from_workload(wl, unit.engines, seed=0)


def _report(sess) -> dict:
    rep = sess.report().to_json()
    rep.pop("wall_s")
    return rep


def _serve(unit, reqs, between=None):
    """Serve ``reqs`` under the logical clock; ``between(n)`` runs
    before the n-th step.  Returns (tokens by request, report)."""
    sess = driver.ServeSession([unit], reqs, cost=driver.TickCostModel())
    n = 0
    while True:
        if between is not None:
            between(n)
        status = sess.step()[0]
        n += 1
        if status == "done":
            break
    return {r.req_id: list(r.output) for r in reqs}, _report(sess)


def _kind_rows(key):
    """(kind, rows of the packed tokens) of a registry key."""
    return key[0][0], key[0][2][0][1][0]


@pytest.mark.parametrize("chunk", [0, 16])
def test_registry_one_program_per_bucket_and_kind(stub, chunk):
    """qwen2-7b, mamba2-2.7b and zamba2-1.2b served through the registry
    give the eager run's tokens and report; every key is captured once;
    whole-prompt prefills at power-of-two rows, SSM chunks and decodes
    at exact rows; the pure-SSM steps key on no arena, the hybrid's and
    the dense ones on the arena's buffers."""
    unit, reqs = _mixed_unit(chunk)
    got = _serve(unit, reqs)
    arena = {t.data_ptr() for t in unit.pool.arena()}
    state = {name: (e.ssm_state.data_ptr() if e.cfg.ssm else None)
             for name, e in unit.engines.items()}
    with graphs.disable_graphs():
        want = _serve(*_mixed_unit(chunk))
    assert got == want
    keys = stub.keys
    assert len(keys) == len(set(keys))
    assert set(graphs.REGISTRY.graphs) == set(keys)
    kinds = {_kind_rows(k)[0] for k in keys}
    assert {"prefill_ssm" if chunk == 0 else "chunk_ssm",
            "decode_ssm"} <= kinds
    assert ("prefill" if chunk == 0 else "chunk") in kinds
    for k in keys:
        kind, rows = _kind_rows(k)
        assert 1 <= rows <= 4
        if kind in ("prefill", "prefill_ssm"):
            assert rows & (rows - 1) == 0
        ptrs = set(k[1])
        if kind.endswith("_ssm"):
            cfg = k[0][1]
            assert (ptrs >= arena) == (cfg.family == "hybrid")
            owner = [n for n, p in state.items() if p in ptrs]
            assert len(owner) == 1
        else:
            assert ptrs >= arena
    # a bucket and kind of one engine: one program
    slots = [(k[0][0], k[0][1], k[0][2], k[0][3]) for k in keys]
    assert len(slots) == len(set(slots))


def _graph_refs_alive() -> bool:
    return all(r() is not None for g in graphs.REGISTRY.graphs.values()
               for r in g.refs)


def test_registry_recaptures_after_recovery(stub):
    """Crash recovery builds a fresh engine with fresh state buffers: the
    dead engine's graphs go with its buffers, the fresh engine's steps
    are captured on its own, and the tokens and report equal the eager
    run's with the same recovery (at the first step where a zamba2-1.2b
    request has decoded twice)."""
    out = {}
    for mode in ("graphs", "eager"):
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            unit, reqs = _mixed_unit(16)
            seen = {}

            def recover(n, unit=unit, seen=seen):
                old = unit.engines["llm2"]
                if "old" in seen or not any(
                        r is not None and len(r.output) >= 2
                        for r in old.slots):
                    return
                seen["old"] = {old.ssm_state.data_ptr(),
                               old.conv_tail.data_ptr()}
                seen["n0"] = len(stub.keys)
                seen["had"] = sum(bool(seen["old"] & set(k[1]))
                                  for k in graphs.REGISTRY.graphs)
                del old
                unit.recover_engine("llm2")
                gc.collect()
            out[mode] = _serve(unit, reqs, recover)
        if mode == "graphs":
            fresh = unit.engines["llm2"]
            assert seen["had"] > 0
            assert _graph_refs_alive()
            assert not any(seen["old"] & set(k[1])
                           for k in graphs.REGISTRY.graphs)
            after = [k for k in stub.keys[seen["n0"]:]
                     if fresh.ssm_state.data_ptr() in k[1]]
            assert {"prefill_ssm", "decode_ssm"} <= {k[0][0] for k in after}
    assert out["graphs"] == out["eager"]


def test_registry_grow_drops_only_the_arena_readers(stub):
    """A ``grow`` past the arena's buffer under live sequences: every
    graph that reads the arena (the dense and hybrid steps) is dropped
    and its step recaptured once; the pure-SSM graphs (mamba2-2.7b's
    chunk and decode) survive and are not captured again.  Tokens and
    report equal the eager run's with the same grow (at the first step
    where a mamba2-2.7b and a zamba2-1.2b request have decoded twice)."""
    out = {}
    for mode in ("graphs", "eager"):
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            unit, reqs = _mixed_unit(16)
            seen = {}

            def grow(n, unit=unit, seen=seen):
                if "old" in seen or not all(
                        any(r is not None and len(r.output) >= 2
                            for r in unit.engines[name].slots)
                        for name in ("llm1", "llm2")):
                    return
                pool = unit.pool
                k_old = pool.arena()[0]
                seen["old"] = {t.data_ptr() for t in pool.arena()}
                seen["before"] = dict(graphs.REGISTRY.graphs)
                seen["n0"] = len(stub.keys)
                assert pool.allocator.used
                pool.grow(k_old.shape[0] - pool.n_head_blocks + 512)
                assert pool.arena()[0] is not k_old
                del k_old
                gc.collect()
            out[mode] = _serve(unit, reqs, grow)
        if mode == "graphs":
            before, left = seen["before"], graphs.REGISTRY.graphs
            readers = [k for k in before if seen["old"] & set(k[1])]
            pure = [k for k in before if not seen["old"] & set(k[1])]
            assert readers and pure
            assert {k[0][0] for k in pure} == {"chunk_ssm", "decode_ssm"}
            assert not set(readers) & set(left)
            assert all(left.get(k) is before[k] for k in pure)
            later = [k[0] for k in stub.keys[seen["n0"]:]]
            assert len(later) == len(set(later))
            assert not set(later) & {k[0] for k in pure}
    assert out["graphs"] == out["eager"]


def _checked_rollbacks(unit, record):
    """Wrap each SSM engine's decode: after it, every rolled-back row's
    state must equal the state before the step, bit for bit.  Records
    (equal, whether the step captured) per rolled-back row."""
    for eng in unit.engines.values():
        if not eng.cfg.ssm:
            continue

        def decode(job, eng=eng, run=eng._decode_ssm):
            before = (eng.ssm_state.clone(), eng.conv_tail.clone())
            log = len(graphs.REGISTRY.log)
            n = run(job)
            for i in eng._rolled_rows:
                s = job.slots[i]
                record.append((bool(
                    torch.equal(eng.ssm_state[:, s], before[0][:, s])
                    and torch.equal(eng.conv_tail[:, s], before[1][:, s])),
                    len(graphs.REGISTRY.log) > log))
            return n
        eng._decode_ssm = decode


def test_rollbacks_under_a_tight_quota(stub):
    """A serve whose SSM and hybrid engines' quotas are clamped to their
    use for one step whenever a decode row of theirs is about to open a
    block (the row rolls back; only zamba2-1.2b's rows hold blocks that
    grow): with graphs the tokens and report equal the eager run's, and
    every rolled-back row's state equals its pre-step state."""
    from repro_torch.config import BLOCK_TOKENS
    out, checks = {}, {}
    for mode in ("graphs", "eager"):
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            unit, reqs = _mixed_unit(0, mean_output=24)
            checks[mode] = []
            _checked_rollbacks(unit, checks[mode])
            ssm = [e for e in unit.engines.values() if e.cfg.ssm]
            held, done = {}, set()

            def clamp(n, ssm=ssm, held=held, done=done):
                for e in ssm:
                    if e.cfg.name in held:
                        e.view.quota = held.pop(e.cfg.name)
                    for slot in e.active_slots():
                        sid = int(e.slot_seq[slot])
                        at = (e.cfg.name, sid, e.view.seqs[sid].n_tokens)
                        if at[2] % BLOCK_TOKENS == 0 and at not in done \
                                and slot not in e._prefilling:
                            done.add(at)
                            held.setdefault(e.cfg.name, e.view.quota)
                            e.view.quota = e.view.used
            out[mode] = _serve(unit, reqs, clamp)
    assert out["graphs"] == out["eager"]
    assert [ok for ok, _ in checks["graphs"]] == \
        [ok for ok, _ in checks["eager"]]
    assert len(checks["graphs"]) >= 2 and all(ok for ok, _ in checks["graphs"])
    # rows rolled back in replayed steps (the graph's copy of the rows)
    assert any(not caught for _, caught in checks["graphs"])


class _FailingCapture(RecordingCapture):
    def record(self, key, fn, device):
        raise RuntimeError("capture failed")


def test_a_failed_capture_raises():
    """A capture that fails raises out of the step: no quiet eager step,
    no graph kept, and the next step tries again."""
    saved = graphs.REGISTRY.capture
    graphs.REGISTRY.clear()
    graphs.REGISTRY.capture = _FailingCapture()
    try:
        unit, reqs = _mixed_unit(16, archs=("mamba2-2.7b",))
        eng = unit.engines["llm0"]
        eng.admit_chunked(reqs[:1])
        with pytest.raises(RuntimeError, match="capture failed"):
            eng.prefill([])
        assert not graphs.REGISTRY.graphs
        assert not graphs.REGISTRY._capturing
        with pytest.raises(RuntimeError, match="capture failed"):
            eng.prefill([])
    finally:
        graphs.REGISTRY.capture = saved
        graphs.REGISTRY.clear()


# ---------------------------------------------------------------------------
# chip_smoke.py's graph steps phase rehearsed through the stub
# ---------------------------------------------------------------------------
def test_graph_steps_phase_rehearses_on_cpu(stub):
    """``serve_graph_steps`` at reduced width: in each run the graph and
    eager serves give one report, tokens and launch counts, each new
    kind is captured and replayed, the compared logits are equal."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    res = chip_smoke.serve_graph_steps(torch, device="cpu", reduced=True)
    assert res["moe_captures"] > 0
    seen = set()
    for label, spec, kinds, _ in chip_smoke.STEP_RUNS:
        r = res["runs"][label]
        g = r["graphs"]
        for kind in kinds:
            assert g["captured"][kind] >= 1 and g["replays"][kind] >= 1
        assert not r["eager"]["captured"]
        assert r["eager"]["ticks"] == g["ticks"] > 0
        assert set(r["logit_rel_err"].values()) == {0.0}
        seen |= set(kinds)
        waves = g["prefill_key_replays"]
        assert len(waves) == chip_smoke.STEP_WAVES
        if waves[0]:
            # the second wave meets every whole-prompt key again
            assert all(waves[1][k] > waves[0][k] for k in waves[0])
    assert set(chip_smoke.NEW_KINDS) <= seen
