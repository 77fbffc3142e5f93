"""Core transformer building blocks in PyTorch (port of
``repro/models/layers.py``).

Parameters are plain nested dicts of tensors, per-layer weights stacked
on a leading layer axis ``[L, ...]`` exactly as in the JAX package, and
applied as ``x @ w`` (``[d_in, d_out]`` layout, no transposes).

A tree may also carry a leading *model* axis ``[M, L, ...]`` (the
stacked weights of a fused group, ``serving/mux.FusedGroup``).  The
projection helpers accept both: with a model axis the activations carry
``M`` as their leading dim too, and every matmul becomes a batched
product over it — the explicit-batch form of the JAX engine's ``vmap``
over the stacked tree.  The TPU mesh helpers (``constrain``,
``shard_activation``) have no counterpart on one GPU and are left out.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# leading model axis
# ---------------------------------------------------------------------------
def _per_model(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View a vector weight (``[n]``, or ``[M, n]`` with a model axis)
    so it broadcasts against activations ``x`` (``[..., n]``, or
    ``[M, ..., n]``)."""
    if w.dim() == 1:
        return w
    return w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` of shape ``[d_in, d_out]`` or ``[M, d_in,
    d_out]`` (then ``x`` is ``[M, ..., d_in]``).  Operands of two
    float types meet in the wider one, as ``jnp.matmul`` promotes them
    (the W8/KV8 step multiplies f32 activations by bf16 weights)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if w.dim() == 2:
        return x @ w
    m, d_in, d_out = w.shape
    y = torch.bmm(x.reshape(m, -1, d_in), w)
    return y.reshape(*x.shape[:-1], d_out)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    w = _per_model(w, x).float()
    return (x * torch.rsqrt(var + eps) * w).to(dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  The
    half-split form (first and second halves of the head rotate
    together), as the JAX package."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs           # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (plain version of kernels/flash_prefill.flash_prefill)
# ---------------------------------------------------------------------------
def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, KV*n_rep, hd] (GQA broadcast)."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    x = x[:, :, :, None, :].expand(b, s, kv, n_rep, hd)
    return x.reshape(b, s, kv * n_rep, hd)


def causal_attention(q, k, v, *, window: Optional[int] = None,
                     q_offset: int = 0) -> torch.Tensor:
    """Plain causal attention.  q: [B,Sq,H,hd], k/v: [B,Sk,KV,hd].

    ``q_offset`` positions q tokens at ``q_offset + arange(Sq)`` in the
    kv timeline.  ``window``: sliding window."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    k = repeat_kv(k, h // kvh)
    v = repeat_kv(v, h // kvh)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# attention block params
# ---------------------------------------------------------------------------
def _normal(shape, scale: float, gen: torch.Generator, dtype,
            device) -> torch.Tensor:
    # scaled in place: a full-width leaf is gigabytes, a temporary copy
    # would double the peak
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def init_attn(cfg: ModelConfig, n_layers: int, gen: torch.Generator,
              dtype=torch.bfloat16, device="cuda") -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sc = 1.0 / math.sqrt(d)
    sco = 1.0 / math.sqrt(h * hd)
    L = n_layers
    p = {
        "wq": _normal((L, d, h * hd), sc, gen, dtype, device),
        "wk": _normal((L, d, kv * hd), sc, gen, dtype, device),
        "wv": _normal((L, d, kv * hd), sc, gen, dtype, device),
        "wo": _normal((L, h * hd, d), sco, gen, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, h * hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((L, kv * hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((L, kv * hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((L, hd), dtype=dtype, device=device)
    return p


def attn_qkv(x, p, li, cfg: ModelConfig, positions):
    """Project to q/k/v (+bias, qk_norm, rope).  x: [B,S,d] (or
    [M,B,S,d] with a model axis on every leaf of ``p``)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = x.shape[:-1]
    sel = (slice(None),) * (p["wq"].dim() - 3) + (li,)
    q = linear(x, p["wq"][sel])
    k = linear(x, p["wk"][sel])
    v = linear(x, p["wv"][sel])
    if cfg.qkv_bias:
        q = q + _per_model(p["bq"][sel], q)
        k = k + _per_model(p["bk"][sel], k)
        v = v + _per_model(p["bv"][sel], v)
    q = q.reshape(*lead, h, hd)
    k = k.reshape(*lead, kv, hd)
    v = v.reshape(*lead, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"][sel], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"][sel], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# dense SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(d: int, f: int, n_layers: int, gen: torch.Generator,
             dtype=torch.bfloat16, device="cuda") -> Params:
    return {
        "w_gate": _normal((n_layers, d, f), 1 / math.sqrt(d), gen, dtype,
                          device),
        "w_up": _normal((n_layers, d, f), 1 / math.sqrt(d), gen, dtype,
                        device),
        "w_down": _normal((n_layers, f, d), 1 / math.sqrt(f), gen, dtype,
                          device),
    }


def mlp(x, p, li):
    sel = (slice(None),) * (p["w_gate"].dim() - 3) + (li,)
    h = F.silu(linear(x, p["w_gate"][sel])) * linear(x, p["w_up"][sel])
    return linear(h, p["w_down"][sel])


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------
def init_embed(cfg: ModelConfig, v_padded: int, gen: torch.Generator,
               dtype=torch.bfloat16, device="cuda") -> Params:
    d = cfg.d_model
    p = {
        "embed": _normal((v_padded, d), 0.02, gen, dtype, device),
        "out_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((d, v_padded), 1 / math.sqrt(d), gen, dtype,
                               device)
    return p


def embed_tokens(embed: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Look tokens up in ``embed`` ``[V, d]`` or, with a model axis,
    ``[M, V, d]`` (then ``toks`` is ``[M, ...]``, model m's tokens
    reading model m's table)."""
    if embed.dim() == 2:
        return embed[toks]
    m = torch.arange(embed.shape[0], device=toks.device)
    return embed[m.reshape(-1, *([1] * (toks.dim() - 1))), toks]


def lm_logits(x, p, cfg: ModelConfig):
    x = rms_norm(x, p["out_norm"], cfg.rms_eps)
    if cfg.tie_embeddings:
        return linear(x, p["embed"].transpose(-1, -2))
    return linear(x, p["lm_head"])
