"""Serve-step definitions of every family (port of
``repro/launch/steps.py``): the jobs MuxServe schedules.

Phases (paper §2.1):
  * ``prefill``: full causal forward over the prompt, emit the KV /
    state caches and the last-token logits (compute-bound job);
  * ``decode``: ONE new token against a cache of ``lens`` context
    (memory-bound job), in bf16/f32 (``make_decode_step``) or with int8
    weights and an int8 KV cache (``make_decode_step_w8kv8``, the
    attention families only, as the reference's).

Cache layouts (the reference's):
  dense/moe/vlm/audio ``cache_k/v [L, B, S, KV, hd]``; the W8/KV8 step's
                      int8 cache carries per-(token, kv head) f32
                      scales ``scale_k/v [L, B, S, KV]``
  windowed            ``wkey/wval [L, B, KV, W, hd]`` ring buffers, the
                      slot of position p is ``p % W``
                      (``cache_ops.write_window``)
  ssm                 ``ssm_state [L, B, H, P, N]`` f32, ``conv_tail [L,
                      B, K-1, C]``
  hybrid (zamba2)     the ssm caches for all L layers plus ``cache_k/v``
                      for the ``L // attn_every`` shared-block
                      applications, dense ``[G, B, S, KV, hd]`` or
                      windowed ``[G, B, KV, W, hd]``.
The layer loop is a Python loop over the stacked ``[L, ...]`` leaves.
Unlike the JAX package the decode steps write the new token's KV, and
the SSM layers' new state and conv tail, into the caches IN PLACE and
return the same tensors (a caller that needs the old cache clones it
first); a position outside a dense cache is dropped, as JAX's scatter
drops it.

Kernels: on CUDA tensors the prompt's causal attention is the
flash-prefill kernel (``cache_ops.flash_prefill``, any prompt length,
optional window), the SSM prefill's scan the SSD kernel (through
``models/mamba2.mamba2_mixer``), and the W8/KV8 decode attention the
int8 decode kernel, which reads each layer of the int8 cache in place;
CPU tensors run their plain versions.  On ``meta`` tensors (the
dry-run, ``launch/dryrun.py``) a prompt of 1024 tokens or more attends
through ``layers.blocked_causal_attention``, as the reference's step
does, and on a mesh the SSM layers of a prefill run sequence-parallel
over the model axis.  The bf16 decode attends over its
dense cache or ring buffer in plain PyTorch, and the SSM decode step is
plain PyTorch: the JAX package has no TPU kernel for them either.

MoE layers run ``models/moe``: ``moe_dropless`` picks the dropless FFN
(a token's output independent of the batch), else the capacity FFN, as
in the reference.  A vlm / audio prefill takes the reference's
``prefix_emb`` (precomputed frontend embeddings, whose frontends are
stubs) before the tokens; the last-token logits then sit at ``lens +
n_pre − 1``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.paged_attention_int8 import \
    dense_decode_attention_int8
from repro_torch.models.layers import (attention_on_shards, attn_qkv,
                                       blocked_causal_attention,
                                       constrain, linear, lm_logits,
                                       local_region, mlp, model_axis_size,
                                       on_local_shards, rms_norm)
from repro_torch.models.mamba2 import mamba2_decode_step, mamba2_mixer
from repro_torch.models.moe import ffn
from repro_torch.paging import dense_decode_attention
from repro_torch.serving.cache_ops import (flash_prefill,
                                           windowed_decode_attention,
                                           write_window)
from repro_torch.serving.quantize import QLayerView, qmatmul, quantize_kv

ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")

# the decode attention's specs on a mesh: rows on (pod, data), heads on
# model (q [B, H, hd], a cache layer [B, S, KV, hd], a ring [B, KV, W, hd])
_BD = ("pod", "data")
_Q, _ROWS = (_BD, "model", None), (_BD,)
_CACHE, _RING = (_BD, None, "model", None), (_BD, "model", None, None)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _attention_prefill(x, lp, li, cfg, positions, window):
    h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
    q, k, v = attn_qkv(h, lp, li, cfg, positions)
    if q.device.type == "meta" and x.shape[1] >= 1024:
        o = blocked_causal_attention(q, k, v, window=window)
    else:
        o = attention_on_shards(
            lambda *a: flash_prefill(*a, window=window), q, k, v)
    b, s, _, _ = o.shape
    return x + linear(o.reshape(b, s, -1), lp["wo"][li]), k, v


def _write_dense(ck, cv, k_new, v_new, pos):
    """Insert one token's KV at pos[b], in place.  ck: [B,S,...];
    k_new [B,...]."""
    on_local_shards(_write_rows, [_CACHE, _Q, _ROWS], ck, k_new, pos)
    on_local_shards(_write_rows, [_CACHE, _Q, _ROWS], cv, v_new, pos)


def _write_rows(cache, new, pos):
    """cache[b, pos[b]] = new[b] in place for every row whose pos lies in
    [0, S); other rows keep their entry (no host sync: the dropped rows
    rewrite what they read)."""
    B, S = cache.shape[:2]
    keep = ((pos >= 0) & (pos < S)).reshape(B, *([1] * (new.dim() - 1)))
    rows = torch.arange(B, device=cache.device)
    at = pos.clamp(0, S - 1)
    cache[rows, at] = torch.where(keep, new.to(cache.dtype), cache[rows, at])


def _attn_decode_token(x, lp, li, cfg, pos):
    """QKV for one token.  x: [B,d] → q/k/v [B,·,hd]."""
    h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
    q, k, v = attn_qkv(h[:, None, :], lp, li, cfg, pos[:, None])
    return q[:, 0], k[:, 0], v[:, 0]


def _ffn_decode(x, lp, li, cfg, dropless):
    h = rms_norm(x, lp["ln2"][li], cfg.rms_eps)
    return x + ffn(h, lp, li, cfg, dropless)


def _decode_attend_dense_q(q, ckq, cvq, sk, sv, lens):
    """Decode attention over one layer of an int8 KV cache.

    ckq/cvq: [B,S,KV,hd] int8; sk/sv: [B,S,KV] f32 per-token scales
    (the int8 decode kernel on CUDA, read in place)."""
    def attend(q, ckq, cvq, sk, sv, lens):
        return dense_decode_attention_int8(q.contiguous(), ckq, cvq, sk, sv,
                                           lens.to(torch.int32))
    scale = (_BD, None, "model")
    return local_region(attend, [_Q, _CACHE, _CACHE, scale, scale, _ROWS],
                        _Q)(q, ckq, cvq, sk, sv, lens)


# ---------------------------------------------------------------------------
# W8/KV8 decode
# ---------------------------------------------------------------------------
def make_decode_step_w8kv8(cfg: ModelConfig, moe_dropless: bool = False):
    """int8-weight + int8-KV decode step (dense, MoE, vlm and audio
    families).

    Params come from ``serving.quantize.quantize_params``; caches carry
    int8 values plus per-(token, head) f32 scales.  The step runs in
    bf16: the embedding and every weight are dequantized to bf16 (a MoE
    layer's experts all, by ``QLayerView``)."""
    if cfg.family not in ATTENTION_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the W8/KV8 decode covers the dense, MoE, vlm and "
            f"audio families, as the JAX package's; the {cfg.family!r} "
            f"family has no W8/KV8 step")

    def decode(qparams, cache_k, cache_v, scale_k, scale_v, last_tok,
               lens):
        tok = qparams["tok"]
        x = (tok["embed_q"][last_tok].to(torch.bfloat16)
             * torch.squeeze(tok["embed_s"]).to(torch.bfloat16))
        pos = lens.long() - 1
        for li in range(cfg.n_layers):
            lp = QLayerView(qparams["layers"], li)
            q, k, v = _attn_decode_token(x, lp, 0, cfg, pos)
            kq, ks_ = quantize_kv(k)
            vq, vs_ = quantize_kv(v)
            _write_dense(cache_k[li], cache_v[li], kq, vq, pos)
            _write_dense(scale_k[li], scale_v[li], ks_, vs_, pos)
            o = _decode_attend_dense_q(q, cache_k[li], cache_v[li],
                                       scale_k[li], scale_v[li], lens)
            x = x + linear(o.reshape(x.shape[0], -1), lp["wo"][0])
            x = _ffn_decode(x, lp, 0, cfg, moe_dropless)
        h = rms_norm(x, tok["out_norm"], cfg.rms_eps)
        if cfg.tie_embeddings:
            # embed scales are per-d column: fold into h, exact
            hs = (h.float() * torch.squeeze(tok["embed_s"])).to(torch.bfloat16)
            logits = hs @ tok["embed_q"].to(torch.bfloat16).T
        else:
            logits = qmatmul(h, tok["lm_head_q"], tok["lm_head_s"])
        return {"logits": logits[..., :cfg.vocab_size],
                "cache_k": cache_k, "cache_v": cache_v,
                "scale_k": scale_k, "scale_v": scale_v}

    return decode


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _last(x, lens, n_pre: int = 0):
    """Each row's hidden state at its last token ``lens + n_pre − 1``."""
    idx = torch.clamp(lens.long() + n_pre - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _ssm_prefill_layer(x, lp, li, cfg, mask, sp):
    h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
    out, st, tail = mamba2_mixer(h, lp, li, cfg, return_cache=True,
                                 length_mask=mask, seq_parallel=sp)
    return x + out, st, tail


def make_prefill_step(cfg: ModelConfig, window: Optional[int] = None,
                      moe_dropless: bool = False):
    """Returns prefill(params, tokens, lens[, prefix_emb]) → outputs
    dict: ``logits`` and ``cache_k/v`` for the attention families,
    ``ssm_state`` / ``conv_tail`` for ssm, all four for the hybrid.
    ``moe_dropless``: the dropless MoE FFN (outputs independent of the
    batch); default the capacity FFN, as the reference.  The SSM and
    hybrid prefills mask positions past ``lens`` out of the state
    (``length_mask``) and take tokens only."""
    fam = cfg.family

    if fam in ATTENTION_FAMILIES:
        def prefill(params, tokens, lens, prefix_emb=None):
            x = params["tok"]["embed"][tokens]
            if prefix_emb is not None:
                x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device).expand(B, S)
            lp = params["layers"]
            ks, vs = [], []
            for li in range(cfg.n_layers):
                x, k, v = _attention_prefill(x, lp, li, cfg, positions,
                                             window)
                h = rms_norm(x, lp["ln2"][li], cfg.rms_eps)
                x = x + ffn(h, lp, li, cfg, moe_dropless)
                ks.append(k)
                vs.append(v)
            n_pre = 0 if prefix_emb is None else prefix_emb.shape[1]
            logits = lm_logits(_last(x, lens, n_pre), params["tok"], cfg)
            return {"logits": logits[..., :cfg.vocab_size],
                    "cache_k": torch.stack(ks), "cache_v": torch.stack(vs)}
        return prefill

    if fam == "ssm":
        def prefill(params, tokens, lens):
            x = params["tok"]["embed"][tokens]
            B, S, _ = x.shape
            mask = torch.arange(S, device=x.device)[None, :] < \
                lens.reshape(B, 1)
            lp = params["layers"]
            sp = model_axis_size()    # sequence-parallel SSD on a mesh
            # the residual stream stays sequence-sharded on the model
            # axis, so the slab reshape inside the mixer is local
            x = constrain(x, ("pod", "data"), "model", None)
            sts, tails = [], []
            for li in range(cfg.n_layers):
                x, st, tail = _ssm_prefill_layer(x, lp, li, cfg, mask, sp)
                x = constrain(x, ("pod", "data"), "model", None)
                sts.append(st)
                tails.append(tail)
            logits = lm_logits(_last(x, lens), params["tok"], cfg)
            return {"logits": logits[..., :cfg.vocab_size],
                    "ssm_state": torch.stack(sts),
                    "conv_tail": torch.stack(tails)}
        return prefill

    if fam == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every

        def prefill(params, tokens, lens):
            x = params["tok"]["embed"][tokens]
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device).expand(B, S)
            mask = positions < lens.reshape(B, 1)
            lp = params["layers"]
            sa = params["shared_attn"]
            sp = model_axis_size()    # sequence-parallel SSD on a mesh
            sts, tails, ks, vs = [], [], [], []
            for li in range(cfg.n_layers):
                x, st, tail = _ssm_prefill_layer(x, lp, li, cfg, mask, sp)
                sts.append(st)
                tails.append(tail)
                if li % cfg.attn_every == cfg.attn_every - 1 and \
                        li < n_groups * cfg.attn_every:
                    # the shared block closes each group of attn_every
                    x, k, v = _attention_prefill(x, sa, 0, cfg, positions,
                                                 window)
                    h = rms_norm(x, sa["ln2"][0], cfg.rms_eps)
                    x = x + mlp(h, sa, 0)
                    ks.append(k)
                    vs.append(v)
            logits = lm_logits(_last(x, lens), params["tok"], cfg)
            return {"logits": logits[..., :cfg.vocab_size],
                    "ssm_state": torch.stack(sts),
                    "conv_tail": torch.stack(tails),
                    "cache_k": torch.stack(ks), "cache_v": torch.stack(vs)}
        return prefill

    raise ValueError(fam)


# ---------------------------------------------------------------------------
# decode — ONE new token with a lens context cache
# ---------------------------------------------------------------------------
def _ssm_decode_layer(x, lp, li, cfg, ssm_state, conv_tail):
    """One Mamba2 layer of a decode step; writes the layer's new state
    and conv tail into ``ssm_state`` / ``conv_tail`` (views) in place."""
    h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
    out, tail2, st2 = mamba2_decode_step(h, lp, li, cfg, conv_tail,
                                         ssm_state)
    ssm_state.copy_(st2)
    conv_tail.copy_(tail2)
    return x + out


def make_decode_step(cfg: ModelConfig, windowed: bool = False,
                     moe_dropless: bool = False):
    """Returns decode(params, caches..., last_tok, lens) → outputs dict.

    ``lens`` is the context length INCLUDING the new token (position
    lens−1).  ``windowed=True`` uses ring-buffer sliding-window caches
    of width ``cfg.sliding_window`` (the attention families' caches
    ``wkey``/``wval``; the hybrid's ``cache_k``/``cache_v``).  The
    signatures are the reference's:
      attention  decode(params, cache_k, cache_v, last_tok, lens)
      windowed   decode(params, wkey, wval, last_tok, lens)
      ssm        decode(params, ssm_state, conv_tail, last_tok, lens)
      hybrid     decode(params, ssm_state, conv_tail, cache_k, cache_v,
                        last_tok, lens)
    """
    fam = cfg.family
    W = cfg.sliding_window if windowed else None
    if windowed and fam != "ssm" and not W:
        raise ValueError(f"{cfg.name} has no sliding_window")

    def attend(q, k, v, ck, cv, pos, lens):
        # write the token's K/V, then attend over the dense cache or the
        # ring buffer of width W (on a mesh shard by shard: rows on
        # (pod, data), kv heads on model)
        if windowed:
            on_local_shards(write_window, [_RING, _RING, _Q, _Q, _ROWS],
                            ck, cv, k, v, pos, written=2)
            return local_region(
                lambda *a: windowed_decode_attention(*a, W),
                [_Q, _RING, _RING, _ROWS], _Q)(q, ck, cv, lens)
        _write_dense(ck, cv, k, v, pos)
        return local_region(dense_decode_attention,
                            [_Q, _CACHE, _CACHE, _ROWS], _Q)(q, ck, cv, lens)

    if fam in ATTENTION_FAMILIES:
        keys = ("wkey", "wval") if windowed else ("cache_k", "cache_v")

        def decode(params, cache_k, cache_v, last_tok, lens):
            x = params["tok"]["embed"][last_tok]          # [B, d]
            pos = lens.long() - 1
            lp = params["layers"]
            for li in range(cfg.n_layers):
                q, k, v = _attn_decode_token(x, lp, li, cfg, pos)
                o = attend(q, k, v, cache_k[li], cache_v[li], pos, lens)
                x = x + linear(o.reshape(x.shape[0], -1), lp["wo"][li])
                x = _ffn_decode(x, lp, li, cfg, moe_dropless)
            logits = lm_logits(x, params["tok"], cfg)
            return {"logits": logits[..., :cfg.vocab_size],
                    keys[0]: cache_k, keys[1]: cache_v}
        return decode

    if fam == "ssm":
        def decode(params, ssm_state, conv_tail, last_tok, lens):
            x = params["tok"]["embed"][last_tok]
            lp = params["layers"]
            for li in range(cfg.n_layers):
                x = _ssm_decode_layer(x, lp, li, cfg, ssm_state[li],
                                      conv_tail[li])
            logits = lm_logits(x, params["tok"], cfg)
            return {"logits": logits[..., :cfg.vocab_size],
                    "ssm_state": ssm_state, "conv_tail": conv_tail}
        return decode

    if fam == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every

        def decode(params, ssm_state, conv_tail, cache_k, cache_v,
                   last_tok, lens):
            x = params["tok"]["embed"][last_tok]
            pos = lens.long() - 1
            lp = params["layers"]
            sa = params["shared_attn"]
            for li in range(cfg.n_layers):
                x = _ssm_decode_layer(x, lp, li, cfg, ssm_state[li],
                                      conv_tail[li])
                gi = li // cfg.attn_every
                if li % cfg.attn_every != cfg.attn_every - 1 or \
                        gi >= n_groups:
                    continue
                # the shared block closes each group of attn_every
                q, k, v = _attn_decode_token(x, sa, 0, cfg, pos)
                o = attend(q, k, v, cache_k[gi], cache_v[gi], pos, lens)
                x = x + linear(o.reshape(x.shape[0], -1), sa["wo"][0])
                h = rms_norm(x, sa["ln2"][0], cfg.rms_eps)
                x = x + mlp(h, sa, 0)
            logits = lm_logits(x, params["tok"], cfg)
            return {"logits": logits[..., :cfg.vocab_size],
                    "ssm_state": ssm_state, "conv_tail": conv_tail,
                    "cache_k": cache_k, "cache_v": cache_v}
        return decode

    raise ValueError(fam)
