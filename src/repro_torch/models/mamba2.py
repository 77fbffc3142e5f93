"""Mamba2 — SSD (state-space duality) mixer in PyTorch (port of
``repro/models/mamba2.py``).

Layer structure (Mamba2 block):
  in_proj: d → [z(di), x(di), B(G·N), C(G·N), dt(H)]
  causal conv1d (kernel K) over [x, B, C]
  SSD: y = SSD(x·dt, A·dt, B, C) + D⊙x
  gated RMSNorm(y · silu(z)); out_proj: di → d

The chunked SSD scan is ``ssd_chunked``: the Hopper kernel
``kernels/ssd_scan`` on CUDA tensors, its plain version on CPU tensors.
Decode keeps a per-sequence cache: conv tail [K-1, conv_dim] and SSM
state [H, P, N] (float32).  The JAX package's mesh paths
(``causal_conv_slabbed``, ``ssd_seq_parallel``) have no counterpart on
one GPU and are left out.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import _normal, rms_norm

# leaves kept in float32 whatever the weight dtype (as the JAX package's
# ``init_mamba2`` keeps them)
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")


def init_mamba2(cfg: ModelConfig, n_layers: int, gen: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Dict:
    """Random Mamba2 weights drawn from ``gen``; the JAX package's tree
    shapes, with ``a_log``, ``dt_bias`` and ``d_skip`` in float32."""
    sc = cfg.ssm
    d, di = cfg.d_model, cfg.d_inner
    H, N, G, K = cfg.n_ssm_heads, sc.d_state, sc.n_groups, sc.conv_kernel
    L = n_layers
    conv_dim = di + 2 * G * N
    d_in_proj = 2 * di + 2 * G * N + H
    f32 = dict(dtype=torch.float32, device=device)

    def per_layer(v):
        return v.expand(L, H).contiguous()
    return {
        "in_proj": _normal((L, d, d_in_proj), 1 / math.sqrt(d), gen, dtype,
                           device),
        "conv_w": _normal((L, K, conv_dim), 0.2, gen, dtype, device),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=device),
        "a_log": per_layer(torch.log(torch.linspace(1.0, 16.0, H, **f32))),
        "dt_bias": per_layer(torch.log(torch.expm1(
            torch.linspace(1e-3, 0.1, H, **f32)))),
        "d_skip": torch.ones((L, H), **f32),
        "gnorm": torch.ones((L, di), dtype=dtype, device=device),
        "out_proj": _normal((L, di, d), 1 / math.sqrt(di), gen, dtype,
                            device),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    sc = cfg.ssm
    di, G, N, H = cfg.d_inner, sc.n_groups, sc.d_state, cfg.n_ssm_heads
    return torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tail=None) -> torch.Tensor:
    """Depthwise causal conv1d.  x: [B,S,C], w: [K,C], tail: [B,K-1,C].
    The sum of K shifted products the JAX package computes (no cuDNN
    convolution, which would run in TF32)."""
    K = w.shape[0]
    S = x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)            # [B, S+K-1, C]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return F.silu(out + b)


# the JAX package's name for the chunked scan: the kernel's wrapper,
# which runs the plain version on CPU tensors (any S; init_state carries
# a sequence's state)
ssd_chunked = ssd_scan


def mamba2_mixer(x, p, li, cfg: ModelConfig, conv_tail=None, ssm_state=None,
                 return_cache=False, length_mask=None):
    """Full Mamba2 block (prefill path).  x: [B,S,d].

    ``length_mask`` [B,S] (True = real token): padded positions get
    dt=0 so they neither update nor decay the SSM state — the final
    state equals the state at the last real token.  ``conv_tail`` /
    ``ssm_state`` carry a sequence across chunks.
    """
    sc = cfg.ssm
    b, s, _ = x.shape
    H, P, G, N, K = (cfg.n_ssm_heads, sc.head_dim, sc.n_groups, sc.d_state,
                     sc.conv_kernel)
    di = cfg.d_inner

    zxbcdt = x @ p["in_proj"][li]
    z, xs, B, C, dt = _split_proj(zxbcdt, cfg)
    xbc_pre = torch.cat([xs, B, C], dim=-1)                 # pre-conv inputs
    xbc = causal_conv(xbc_pre, p["conv_w"][li], p["conv_b"][li], conv_tail)
    xs, B, C = torch.split(xbc, [di, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][li])
    if length_mask is not None:
        dt = dt * length_mask[:, :, None].to(dt.dtype)
    # a chunk of min(chunk_size, S); a longer S that the chunk does not
    # divide is padded inside the scan (the JAX package asserts there)
    y, final_state = ssd_chunked(
        xs.reshape(b, s, H, P).contiguous(), dt.contiguous(),
        p["a_log"][li], B.reshape(b, s, G, N).contiguous(),
        C.reshape(b, s, G, N).contiguous(), p["d_skip"][li],
        min(sc.chunk_size, s), init_state=ssm_state)
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), p["gnorm"][li], cfg.rms_eps)
    out = y @ p["out_proj"][li]
    if not return_cache:
        return out, final_state
    # conv tail = last K-1 *pre-activation* conv inputs of each sequence
    # (positions len-K+1 .. len-1; zeros when shorter than K-1)
    prev = conv_tail if conv_tail is not None else torch.zeros(
        (b, K - 1, xbc_pre.shape[-1]), dtype=x.dtype, device=x.device)
    full = torch.cat([prev.to(xbc_pre.dtype), xbc_pre], dim=1)
    if length_mask is not None:
        lens = length_mask.sum(dim=1).to(torch.int64)
    else:
        lens = torch.full((b,), s, dtype=torch.int64, device=x.device)
    idx = lens[:, None] + torch.arange(K - 1, device=x.device)[None, :]
    new_tail = torch.gather(full, 1, idx[:, :, None].expand(
        b, K - 1, full.shape[-1]))
    return out, final_state, new_tail


def mamba2_decode_step(x, p, li, cfg: ModelConfig, conv_tail, ssm_state):
    """Single-token decode.  x: [B,d]; conv_tail: [B,K-1,conv_dim];
    ssm_state: [B,H,P,N] (float32).  Returns (out, new_tail,
    new_state); the inputs are not modified."""
    sc = cfg.ssm
    b = x.shape[0]
    H, P, G, N = cfg.n_ssm_heads, sc.head_dim, sc.n_groups, sc.d_state
    di = cfg.d_inner

    zxbcdt = x @ p["in_proj"][li]
    z, xs, B, C, dt = _split_proj(zxbcdt, cfg)
    xbc_new = torch.cat([xs, B, C], dim=-1)                 # [B, conv_dim]

    window = torch.cat([conv_tail, xbc_new[:, None].to(conv_tail.dtype)],
                       dim=1)                               # [B,K,conv]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"][li]) \
        + p["conv_b"][li]
    conv_out = F.silu(conv_out)
    new_tail = window[:, 1:]

    xs, B, C = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][li])         # [B,H]
    a = -torch.exp(p["a_log"][li].float())                  # [H]
    dA = torch.exp(dt * a)                                  # [B,H]

    xh = xs.reshape(b, H, P).float()
    Bg = B.reshape(b, G, N).repeat_interleave(H // G, dim=1).float()
    Cg = C.reshape(b, G, N).repeat_interleave(H // G, dim=1).float()

    # s ← s·exp(dtA) + dt·(B ⊗ x)
    new_state = ssm_state * dA[:, :, None, None] + \
        torch.einsum("bhp,bhN,bh->bhpN", xh, Bg, dt)
    y = torch.einsum("bhpN,bhN->bhp", new_state, Cg) + \
        p["d_skip"][li][None, :, None] * xh
    y = y.reshape(b, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"][li], cfg.rms_eps)
    return y @ p["out_proj"][li], new_tail, new_state
