"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Top-k routing over ``n_experts`` SwiGLU experts whose weights are
stacked ``[L, E, d, f_e]`` (``w_down`` ``[L, E, f_e, d]``), the router
``[L, d, E]`` in float32.  Two FFNs, as in the reference:

* ``moe_ffn_dropless`` (the serving path): every token goes through its
  top-k experts and nothing is dropped, so a token's output does not
  depend on the batch.  The reference gathers each token's expert
  weights (``[T, k, d, f_e]``, "fine for the CPU engine"); at full width
  that is gigabytes a chunk.  Here the T·k (token, slot) pairs are
  grouped by expert (a stable argsort of the expert index) and each
  active expert runs ``[n_e, d] @ [d, f_e]`` products with
  ``torch.matmul``, reading its weights once; the slot outputs go back
  to token order and are summed over the k slots with the gates, as the
  reference sums them.  Transient memory is O(T·k·(d + f_e)).  Reading
  the per-expert counts is one host synchronisation per call (per MoE
  layer of a step).
* ``moe_ffn``: static per-expert capacity (Switch/GShard): tokens past
  an expert's capacity are dropped.  The reference's distributed path;
  here the prefill step's default, as there.

The expert products are plain matrix products (XLA's in the reference,
not a Pallas kernel), so they stay ``torch.matmul``.

``ffn`` is the one place that picks a layer's FFN (the dense MLP or a
MoE FFN) for the engine and the serve steps.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models.layers import mlp

_LEAVES = ("router", "w_gate", "w_up", "w_down")


def init_moe(cfg: ModelConfig, n_layers: int, gen: torch.Generator,
             dtype=torch.bfloat16, device="cuda") -> Dict:
    """Random router (float32, as the reference) and expert weights
    drawn from ``gen``; the reference's shapes and scales."""
    mc = cfg.moe
    d, fe, E, L = cfg.d_model, mc.d_expert, mc.n_experts, n_layers

    def normal(shape, scale, dt):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device).mul_(scale)
    return {
        "router": normal((L, d, E), 0.02, torch.float32),
        "w_gate": normal((L, E, d, fe), 1 / math.sqrt(d), dtype),
        "w_up": normal((L, E, d, fe), 1 / math.sqrt(d), dtype),
        "w_down": normal((L, E, fe, d), 1 / math.sqrt(fe), dtype),
    }


def expert_capacity(n_tokens: int, mc: MoEConfig) -> int:
    cap = int(math.ceil(n_tokens * mc.top_k / mc.n_experts
                        * mc.capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)   # the reference's multiple of 8


def route(x: torch.Tensor, router_w: torch.Tensor, mc: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, d] → (gates [T, k] f32, expert_idx [T, k], aux_loss).
    Scores in float32, as the reference, so both packages pick the same
    experts."""
    logits = x.float() @ router_w.float()                 # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, mc.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss
    me = probs.mean(0)                                    # mean prob per expert
    ce = torch.zeros(mc.n_experts, dtype=torch.float32, device=x.device)
    ce = ce.index_add(0, idx[:, 0], torch.ones_like(idx[:, 0],
                                                    dtype=torch.float32))
    ce = ce / x.shape[0]
    aux = mc.n_experts * torch.sum(me * ce) * mc.aux_loss_coef
    return gates, idx, aux


def _swiglu(x, wg, wu, wd):
    """SwiGLU of tokens ``x`` through one expert (``[n, d]``) or every
    expert (``[E, n, d]`` against ``[E, d, f]``): operands meet in the
    wider float type, as ``jnp.einsum`` promotes them."""
    dt = torch.promote_types(x.dtype, wg.dtype)
    x = x.to(dt)
    h = F.silu(x @ wg.to(dt)) * (x @ wu.to(dt))
    return h @ wd.to(dt)


def moe_ffn_dropless(x: torch.Tensor, p: Dict, li, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE.  x: [b, s, d] → (out [b, s, d], aux_loss); ``p``
    holds the stacked leaves (``router``, ``w_gate``, ``w_up``,
    ``w_down``) indexed by layer ``li``."""
    mc = cfg.moe
    b, s, d = x.shape
    T, k = b * s, mc.top_k
    xt = x.reshape(T, d)
    gates, idx, aux = route(xt, p["router"][li], mc)      # [T, k]
    wg, wu, wd = p["w_gate"][li], p["w_up"][li], p["w_down"][li]
    flat_e = idx.reshape(-1)                              # [T*k]
    order = torch.argsort(flat_e, stable=True)            # slots by expert
    counts = torch.bincount(flat_e, minlength=mc.n_experts).tolist()
    xs = xt[order // k]                                   # [T*k, d]
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(_swiglu(xs[start:start + n], wg[e], wu[e], wd[e]))
            start += n
    y_sorted = torch.cat(outs)
    y = torch.empty_like(y_sorted)
    y[order] = y_sorted                                   # slot order
    out = (y.reshape(T, k, d) * gates[..., None].to(y.dtype)).sum(dim=1)
    return out.reshape(b, s, d), aux


def moe_ffn(x: torch.Tensor, p: Dict, li, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch.  x: [B, S, d] → (out [B, S, d],
    aux_loss): each expert takes at most ``expert_capacity(T)`` of its
    (token, slot) pairs, in flat order; the rest are dropped."""
    mc = cfg.moe
    b, s, d = x.shape
    T = b * s
    xt = x.reshape(T, d)
    gates, idx, aux = route(xt, p["router"][li], mc)     # [T, k]
    E, k = mc.n_experts, mc.top_k
    cap = expert_capacity(T, mc)

    # position of each (token, slot) within its expert, in flat order
    flat_e = idx.reshape(-1)                              # [T*k]
    onehot = F.one_hot(flat_e, E).to(torch.int32)         # [T*k, E]
    pos_in_e = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                            flat_e[:, None])[:, 0]
    keep = pos_in_e < cap                                 # capacity mask

    # dispatch: [E, cap, d]; dropped slots add 0 at (0, cap - 1)
    e_safe = torch.where(keep, flat_e, 0)
    p_safe = torch.where(keep, pos_in_e, cap - 1)
    xt_rep = xt[:, None].expand(T, k, d).reshape(T * k, d)
    upd = torch.where(keep[:, None], xt_rep, torch.zeros((), dtype=xt.dtype))
    disp = torch.zeros((E, cap, d), dtype=xt.dtype, device=xt.device)
    disp.index_put_((e_safe, p_safe), upd, accumulate=True)

    # expert FFN: [E, cap, d] x [E, d, fe]
    y = _swiglu(disp, p["w_gate"][li], p["w_up"][li], p["w_down"][li])

    # combine: slot outputs back in token order, summed over the k slots
    slot_out = y[e_safe, p_safe]                          # [T*k, d]
    slot_out = torch.where(keep[:, None], slot_out,
                           torch.zeros((), dtype=slot_out.dtype))
    w = (gates.reshape(-1) * keep).to(slot_out.dtype)     # [T*k]
    out = (slot_out * w[:, None]).reshape(T, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux


def ffn(h: torch.Tensor, lp, li, cfg: ModelConfig, dropless: bool = True
        ) -> torch.Tensor:
    """The FFN of layer ``li`` on ``h`` [..., d]: the dense MLP, or the
    MoE FFN (dropless by default, as the engine runs it; else the
    capacity FFN).  ``lp`` holds the stacked leaves ``[L, ...]``, or a
    stacked tree's ``[M, L, ...]``; a MoE tree is never fused, so its M
    is 1.  Both MoE FFNs flatten the tokens in order, so ``h`` goes
    through as one batch of tokens."""
    if cfg.family != "moe":
        return mlp(h, lp, li)
    if lp["router"].dim() == 4:                           # [M, L, d, E]
        assert lp["router"].shape[0] == 1, "a MoE tree is never fused"
        lp = {k: lp[k][0] for k in _LEAVES}
    fn = moe_ffn_dropless if dropless else moe_ffn
    out, _ = fn(h.reshape(1, -1, h.shape[-1]), lp, li, cfg)
    return out.reshape(h.shape)
