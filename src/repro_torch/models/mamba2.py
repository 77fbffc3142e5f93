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
state [H, P, N] (float32).  The mesh paths of the dry-run
(``causal_conv_slabbed``, ``ssd_seq_parallel``: the sequence cut into
slabs that ride the model axis) run in plain PyTorch; ``mamba2_mixer``
takes them with ``seq_parallel > 1``, which only a mesh sets.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import (_normal, constrain, current_mesh,
                                       gathered, local_region, rms_norm)

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


def causal_conv_slabbed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        slabs: int) -> torch.Tensor:
    """Causal conv over a sequence whose slabs ride the model axis.

    The K−1 halo of each slab is the previous slab's tail, a shift along
    the (sharded) slab dim: a [B, slabs, K−1, C] boundary exchange
    instead of a reshard of the whole shifted sequence.  A zero halo for
    the first slab is a zero conv tail (prefill semantics)."""
    B_, S, C = x.shape
    K = w.shape[0]
    Ls = S // slabs
    xs = x.reshape(B_, slabs, Ls, C)
    xs = constrain(xs, ("pod", "data"), "model", None, None)
    tails = xs[:, :, Ls - (K - 1):, :]                      # [B,slabs,K-1,C]
    halo = F.pad(tails[:, :-1], (0, 0, 0, 0, 1, 0))
    xp = torch.cat([halo, xs], dim=2)                       # [B,slabs,K-1+Ls,C]
    out = sum(xp[:, :, i:i + Ls] * w[i] for i in range(K))
    out = F.silu(out + b)
    return out.reshape(B_, S, C)


def ssd_chunked(x, dt, a_log, B, C, d_skip, chunk: int, init_state=None,
                shard_heads: bool = True):
    """The chunked SSD scan: the kernel's wrapper ``ssd_scan`` (kernel 4
    on CUDA tensors, its plain version on CPU and meta tensors; any S,
    ``init_state`` carries a sequence's state).  Inside a mesh the
    grouped B / C are first broadcast to the heads and constrained to
    the model axis with them (``shard_heads``), as the reference
    constrains its repeated B / C: the scan then runs head-parallel
    instead of replicated on every model rank."""
    if not (shard_heads and current_mesh() is not None):
        return ssd_scan(x, dt, a_log, B, C, d_skip, chunk, init_state)
    rep = x.shape[2] // B.shape[2]
    B, C = (constrain(t.repeat_interleave(rep, dim=2),
                      ("pod", "data"), None, "model", None) for t in (B, C))
    # the scan is independent per (row, head): it runs shard by shard
    bd = ("pod", "data")
    seq, head = (bd, None, "model", None), ("model",)
    state = (bd, "model", None, None)
    return local_region(
        lambda *a: ssd_scan(*a[:6], chunk, a[6]),
        [seq, (bd, None, "model"), head, seq, seq, head,
         None if init_state is None else state],
        [seq, state])(x, dt, a_log, B, C, d_skip, init_state)


def _slab_scans(xs, dts, a_log, Bs, Cs, d_skip, chunk: int):
    """The chunked SSD of every slab from a zero state.  xs [b, slabs,
    Ls, H, P], dts [b, slabs, Ls, H], Bs / Cs [b, slabs, Ls, G, N] →
    (y [b, slabs, Ls, H, P], slab state [b, slabs, H, P, N], slab
    log-decay Σ dA [b, slabs, H], in-slab cumulative log-decay [b, slabs,
    Ls, H]).  Slabs are independent: on a mesh each device scans its
    own."""
    b, n, Ls, H, P = xs.shape
    N = Bs.shape[-1]

    def rows(t):
        return t.reshape((b * n, Ls) + tuple(t.shape[3:]))
    y, fs = ssd_chunked(rows(xs), rows(dts), a_log, rows(Bs), rows(Cs),
                        d_skip, chunk, shard_heads=False)
    a = -torch.exp(a_log.to(torch.float32))                  # [H]
    l_loc = torch.cumsum(dts.to(torch.float32) * a, dim=2)    # [b,n,Ls,H]
    return (y.reshape(b, n, Ls, H, P), fs.reshape(b, n, H, P, N),
            l_loc[:, :, -1], l_loc)


def _slab_correct(y_loc, Cs, prefix, l_loc):
    """y[t] += exp(l_local(t)) · C_t · prefix state of t's slab, in
    float32.  y_loc [b, slabs, Ls, H, P], Cs [b, slabs, Ls, G, N],
    prefix [b, slabs, H, P, N], l_loc [b, slabs, Ls, H]."""
    H = y_loc.shape[3]
    Ch = Cs.to(torch.float32).repeat_interleave(H // Cs.shape[3], dim=3)
    corr = torch.einsum("bsihN,bshpN,bsih->bsihp", Ch, prefix,
                        torch.exp(l_loc))
    return y_loc.to(torch.float32) + corr


def ssd_seq_parallel(x, dt, a_log, B, C, d_skip, chunk: int, slabs: int):
    """Sequence-parallel chunked SSD (the prefill path on a mesh).

    The sequence is cut into ``slabs`` (on a mesh they ride the model
    axis, one a device); each slab runs the local chunked SSD from a
    zero state, and the cross-slab composition uses that the SSM is
    affine in its state:

        s_out = D_slab ⊙ s_in + s_local,  D_slab = exp(Σ_slab dA)

    so a [b, slabs, H, P, N] prefix scan replaces the per-layer
    tensor-parallel all-reduces of head sharding.  On a mesh the slab
    scans and the correction run shard by shard (``local_region``: the
    reference's slab-major merge of the batch is a local reshape there)
    and only the slab states cross devices.  Equal to ``ssd_chunked``
    up to float32 reassociation.  Returns (y [b,S,H,P], final state
    [b,H,P,N] float32)."""
    b, S, H, P = x.shape
    if S % slabs:
        raise ValueError(f"sequence {S} is not a multiple of {slabs} slabs")
    Ls = S // slabs
    f32 = torch.float32

    def slab(t):                          # [b, S, ...] → [b, slabs, Ls, ...]
        return t.reshape((b, slabs, Ls) + tuple(t.shape[2:]))

    bd = ("pod", "data")
    s4, s5 = (bd, "model", None, None), (bd, "model", None, None, None)
    y_loc, fs, D, l_loc = local_region(
        _slab_scans, [s5, s4, (None,), s5, s5, (None,), None],
        [s5, s5, (bd, "model", None), s4])(
            slab(x), slab(dt), a_log, slab(B), slab(C), d_skip,
            min(chunk, Ls))

    # prefix states across slabs: the slab states cross devices here
    fs = constrain(fs, bd, None, None, None, None)
    D = constrain(D, bd, None, None)
    s_in = torch.zeros_like(fs[:, 0], dtype=f32)
    prefix = []
    for i in range(slabs):
        prefix.append(s_in)
        s_in = s_in * torch.exp(D[:, i])[:, :, None, None] + fs[:, i]
    prefix = torch.stack(prefix, dim=1)                  # [b,slabs,H,P,N]

    y = local_region(_slab_correct, [s5, s5, s5, s4], s5)(
        y_loc, slab(C), prefix, l_loc)
    return y.reshape(b, S, H, P).to(x.dtype), s_in


def mamba2_mixer(x, p, li, cfg: ModelConfig, conv_tail=None, ssm_state=None,
                 return_cache=False, length_mask=None, seq_parallel: int = 0):
    """Full Mamba2 block (prefill path).  x: [B,S,d].

    ``length_mask`` [B,S] (True = real token): padded positions get
    dt=0 so they neither update nor decay the SSM state — the final
    state equals the state at the last real token.  ``conv_tail`` /
    ``ssm_state`` carry a sequence across chunks.  ``seq_parallel > 1``
    (the model axis's size on a mesh) cuts a fresh sequence that many
    ways divides into slabs: ``causal_conv_slabbed`` and
    ``ssd_seq_parallel``.
    """
    sc = cfg.ssm
    b, s, _ = x.shape
    H, P, G, N, K = (cfg.n_ssm_heads, sc.head_dim, sc.n_groups, sc.d_state,
                     sc.conv_kernel)
    di = cfg.d_inner

    zxbcdt = x @ gathered(p["in_proj"][li])
    z, xs, B, C, dt = _split_proj(zxbcdt, cfg)
    xbc_pre = torch.cat([xs, B, C], dim=-1)                 # pre-conv inputs
    slabbed = seq_parallel > 1 and s % seq_parallel == 0
    if slabbed and conv_tail is None:
        xbc = causal_conv_slabbed(xbc_pre, p["conv_w"][li], p["conv_b"][li],
                                  seq_parallel)
    else:
        xbc = causal_conv(xbc_pre, p["conv_w"][li], p["conv_b"][li],
                          conv_tail)
    xs, B, C = torch.split(xbc, [di, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][li])
    if length_mask is not None:
        dt = dt * length_mask[:, :, None].to(dt.dtype)
    xh = xs.reshape(b, s, H, P).contiguous()
    Bg = B.reshape(b, s, G, N).contiguous()
    Cg = C.reshape(b, s, G, N).contiguous()
    # a chunk of min(chunk_size, S); a longer S that the chunk does not
    # divide is padded inside the scan (the JAX package asserts there)
    chunk = min(sc.chunk_size, s)
    if slabbed and ssm_state is None:
        y, final_state = ssd_seq_parallel(xh, dt, p["a_log"][li], Bg, Cg,
                                          p["d_skip"][li], chunk,
                                          slabs=seq_parallel)
    else:
        # SSM head parallelism: heads ride the model axis (the scan is
        # independent per head)
        xh = constrain(xh, ("pod", "data"), None, "model", None)
        dt = constrain(dt, ("pod", "data"), None, "model")
        y, final_state = ssd_chunked(xh, dt.contiguous(), p["a_log"][li],
                                     Bg, Cg, p["d_skip"][li], chunk,
                                     init_state=ssm_state)
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), p["gnorm"][li], cfg.rms_eps)
    out = y @ gathered(p["out_proj"][li])
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

    zxbcdt = x @ gathered(p["in_proj"][li])
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
    return y @ gathered(p["out_proj"][li]), new_tail, new_state
