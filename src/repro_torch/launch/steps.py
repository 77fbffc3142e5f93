"""Serve-step definitions of the attention families — dense, MoE, vlm
and audio (port of those branches of ``repro/launch/steps.py``).

Phases (paper §2.1):
  * ``prefill``: full causal forward over the prompt, emit the KV cache
    and the last-token logits (compute-bound job);
  * ``decode``: ONE new token against a cache of ``lens`` context
    (memory-bound job), in bf16/f32 (``make_decode_step``) or with int8
    weights and an int8 KV cache (``make_decode_step_w8kv8``).

Cache layout: ``cache_k/v [L, B, S, KV, hd]``; the W8/KV8 step's int8
cache carries per-(token, kv head) f32 scales ``scale_k/v [L, B, S,
KV]``.  The layer loop is a Python loop over the stacked ``[L, ...]``
leaves.  Unlike the JAX package the decode steps write the new token's
KV into the caches IN PLACE and return the same tensors (a caller that
needs the old cache clones it first); a position outside the cache is
dropped, as JAX's scatter drops it.

Kernels: on CUDA tensors the prompt's causal attention is the
flash-prefill kernel (``cache_ops.flash_prefill``, any prompt length)
and the W8/KV8 decode attention is the int8 decode kernel, which reads
each layer of the int8 cache in place; CPU tensors run their plain
versions.  The bf16 decode attends over its dense cache in plain
PyTorch: the JAX package has no TPU kernel for it either.

MoE layers run ``models/moe``: ``moe_dropless`` picks the dropless FFN
(a token's output independent of the batch), else the capacity FFN, as
in the reference.  A vlm / audio prefill takes tokens only: the
reference's ``prefix_emb`` (precomputed frontend embeddings, whose
frontends are stubs) is not ported.

Not ported yet (they raise): the sliding-window decode and the SSM /
hybrid steps (the engine serves those families through
``serving/engine.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.paged_attention_int8 import \
    dense_decode_attention_int8
from repro_torch.models.layers import attn_qkv, linear, lm_logits, rms_norm
from repro_torch.models.moe import ffn
from repro_torch.paging import dense_decode_attention
from repro_torch.serving.cache_ops import flash_prefill
from repro_torch.serving.quantize import QLayerView, qmatmul, quantize_kv


def _attention_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "audio"):
        raise NotImplementedError(
            f"{what}: the port's serve steps cover the dense, MoE, vlm "
            f"and audio families; {cfg.family!r} ({cfg.name}) is not "
            f"ported yet")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _attention_prefill(x, lp, li, cfg, positions, window):
    h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
    q, k, v = attn_qkv(h, lp, li, cfg, positions)
    o = flash_prefill(q, k, v, window=window)
    b, s, _, _ = o.shape
    return x + linear(o.reshape(b, s, -1), lp["wo"][li]), k, v


def _write_dense(ck, cv, k_new, v_new, pos):
    """Insert one token's KV at pos[b], in place.  ck: [B,S,...];
    k_new [B,...]."""
    _write_rows(ck, k_new, pos)
    _write_rows(cv, v_new, pos)


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
    return dense_decode_attention_int8(q.contiguous(), ckq, cvq, sk, sv,
                                       lens.to(torch.int32))


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
    _attention_only(cfg, "W8/KV8 decode")

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
def make_prefill_step(cfg: ModelConfig, window: Optional[int] = None,
                      moe_dropless: bool = False):
    """Returns prefill(params, tokens, lens) → {logits, cache_k,
    cache_v}; vlm / audio prefill takes tokens only.  ``moe_dropless``:
    the dropless MoE FFN (outputs independent of the batch); default the
    capacity FFN, as the reference."""
    _attention_only(cfg, "prefill")

    def prefill(params, tokens, lens):
        x = params["tok"]["embed"][tokens]
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        lp = params["layers"]
        ks, vs = [], []
        for li in range(cfg.n_layers):
            x, k, v = _attention_prefill(x, lp, li, cfg, positions, window)
            h = rms_norm(x, lp["ln2"][li], cfg.rms_eps)
            x = x + ffn(h, lp, li, cfg, moe_dropless)
            ks.append(k)
            vs.append(v)
        idx = torch.clamp(lens.long() - 1, min=0)
        x_last = x[torch.arange(B, device=x.device), idx]
        logits = lm_logits(x_last, params["tok"], cfg)
        return {"logits": logits[..., :cfg.vocab_size],
                "cache_k": torch.stack(ks), "cache_v": torch.stack(vs)}
    return prefill


# ---------------------------------------------------------------------------
# decode — ONE new token with a lens context cache
# ---------------------------------------------------------------------------
def make_decode_step(cfg: ModelConfig, windowed: bool = False,
                     moe_dropless: bool = False):
    """Returns decode(params, cache_k, cache_v, last_tok, lens) → outputs
    dict.  ``lens`` is the context length INCLUDING the new token
    (position lens−1)."""
    _attention_only(cfg, "decode")
    if windowed:
        raise NotImplementedError(
            "the sliding-window decode (write_window, "
            "windowed_decode_attention) is not ported yet")

    def decode(params, cache_k, cache_v, last_tok, lens):
        x = params["tok"]["embed"][last_tok]          # [B, d]
        pos = lens.long() - 1
        lp = params["layers"]
        for li in range(cfg.n_layers):
            q, k, v = _attn_decode_token(x, lp, li, cfg, pos)
            _write_dense(cache_k[li], cache_v[li], k, v, pos)
            o = dense_decode_attention(q, cache_k[li], cache_v[li], lens)
            x = x + linear(o.reshape(x.shape[0], -1), lp["wo"][li])
            x = _ffn_decode(x, lp, li, cfg, moe_dropless)
        logits = lm_logits(x, params["tok"], cfg)
        return {"logits": logits[..., :cfg.vocab_size],
                "cache_k": cache_k, "cache_v": cache_v}
    return decode
