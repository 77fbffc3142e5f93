"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Top-k routing over ``n_experts`` SwiGLU experts whose weights are
stacked ``[L, E, d, f_e]`` (``w_down`` ``[L, E, f_e, d]``), the router
``[L, d, E]`` in float32.  Two FFNs, as in the reference:

* ``moe_ffn_dropless`` (the serving path): every token goes through its
  top-k experts and nothing is dropped, so a token's output does not
  depend on the batch.  The reference gathers each token's expert
  weights (``[T, k, d, f_e]``, "fine for the CPU engine"); at full width
  that is gigabytes a chunk.  Here the T·k (token, slot) pairs are
  sorted by expert on the device (``kernels/moe_grouped.sort_slots``)
  and go through the grouped-expert SwiGLU (``grouped_swiglu``: kernel
  6 on CUDA, each active expert's weights read once; the grouped loop
  of ``torch.matmul`` products on the CPU); the slot outputs, in slot
  order, are summed over the k slots with the gates, as the reference
  sums them.  Transient memory is O(T·k·(d + f_e)).  On CUDA tensors
  nothing is read on the host, so the serving steps capture as CUDA
  graphs.
* ``moe_ffn``: static per-expert capacity (Switch/GShard): tokens past
  an expert's capacity are dropped.  The reference's distributed path;
  here the prefill step's default, as there.  Its expert products are
  plain batched matrix products (XLA's in the reference), so they stay
  ``torch.matmul``.

``ffn`` is the one place that picks a layer's FFN (the dense MLP or a
MoE FFN) for the engine and the serve steps.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.kernels import moe_grouped as MG
from repro_torch.models.layers import (constrain, current_mesh, gathered,
                                       grad_placements, mlp, placements)

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
    logits = x.float() @ gathered(router_w).float()       # [T, E]
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
    """``moe_grouped.swiglu`` on the weights gathered from a mesh."""
    return MG.swiglu(x, gathered(wg), gathered(wu), gathered(wd))


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
    wg = gathered(p["w_gate"][li])
    dt = torch.promote_types(xt.dtype, wg.dtype)          # as jnp.einsum
    wg, wu, wd = (w.to(dt) for w in (wg, gathered(p["w_up"][li]),
                                     gathered(p["w_down"][li])))
    order, offsets = MG.sort_slots(idx, mc.n_experts)
    y = MG.grouped_swiglu(xt.to(dt).contiguous(), order, offsets, wg, wu,
                          wd, k)                          # [T*k, d]
    out = (y.reshape(T, k, d) * gates[..., None].to(y.dtype)).sum(dim=1)
    return out.reshape(b, s, d), aux


def moe_ffn(x: torch.Tensor, p: Dict, li, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch.  x: [B, S, d] → (out [B, S, d],
    aux_loss): each expert takes at most ``expert_capacity(T)`` of its
    (token, slot) pairs, in flat order; the rest are dropped.

    On a mesh the token-major tensors ride the (pod, data) axes and the
    expert-major dispatch buffer the model axis, as the reference
    constrains them: the token-sharded → expert-sharded transition is
    the expert-parallel exchange."""
    mc = cfg.moe
    b, s, d = x.shape
    T = b * s
    xt = constrain(x.reshape(T, d), ("pod", "data"), None)
    gates, idx, aux = route(xt, p["router"][li], mc)     # [T, k]
    E, k = mc.n_experts, mc.top_k
    cap = expert_capacity(T, mc)

    # position of each (token, slot) within its expert, in flat order
    flat_e = idx.reshape(-1)                              # [T*k]
    onehot = F.one_hot(flat_e, E).to(torch.int32)         # [T*k, E]
    pos_in_e = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                            flat_e[:, None])[:, 0]
    keep = pos_in_e < cap                                 # capacity mask

    # dispatch: [E, cap, d]; dropped slots add 0 at (0, cap - 1).  Slot
    # i belongs to token i // k: the token→slot expansion is a local
    # broadcast, the scatter into the E-major buffer the exchange.
    e_safe = torch.where(keep, flat_e, 0)
    p_safe = torch.where(keep, pos_in_e, cap - 1)
    xt_rep = xt[:, None].expand(T, k, d).reshape(T * k, d)
    upd = torch.where(keep[:, None], xt_rep, xt.new_zeros(()))
    upd = constrain(upd, ("pod", "data"), None)
    disp = _dispatch(upd, e_safe, p_safe, E, cap)
    disp = constrain(disp, "model", None, None)

    # expert FFN: [E, cap, d] x [E, d, fe]  (E on the model axis)
    y = _swiglu(disp, p["w_gate"][li], p["w_up"][li], p["w_down"][li])
    y = constrain(y, "model", None, None)

    # combine: slot outputs back in token order, summed over the k slots
    slot_out = _combine(y, e_safe, p_safe)                # [T*k, d]
    slot_out = constrain(slot_out, ("pod", "data"), None)
    slot_out = torch.where(keep[:, None], slot_out, slot_out.new_zeros(()))
    w = (gates.reshape(-1) * keep).to(slot_out.dtype)     # [T*k]
    out = (slot_out * w[:, None]).reshape(T, k, d).sum(dim=1)
    out = constrain(out, ("pod", "data"), None)
    return out.reshape(b, s, d), aux


def _dispatch(upd, e_safe, p_safe, E: int, cap: int) -> torch.Tensor:
    """The [E, cap, d] buffer with ``upd``'s rows added at (e_safe,
    p_safe)."""
    if current_mesh() is not None:
        return _dispatch_on_mesh(upd, e_safe, p_safe, E, cap)
    disp = torch.zeros((E, cap, upd.shape[-1]), dtype=upd.dtype,
                       device=upd.device)
    disp.index_put_((e_safe, p_safe), upd, accumulate=True)
    return disp


def _combine(y, e_safe, p_safe) -> torch.Tensor:
    """The slot rows ``y[e_safe, p_safe]`` of the expert outputs."""
    if current_mesh() is not None:
        return _combine_on_mesh(y, e_safe, p_safe)
    return y[e_safe, p_safe]


# On a mesh the scatter into the expert-major buffer and the gather back
# have no DTensor rule.  Each runs shard by shard (``local_map``) between
# the reference's constraint specs: a device scatters the slots of its
# own tokens that go to its own experts, and the token shards' partial
# buffers are summed over (pod, data); on the way back a device gathers
# its tokens' slots from its own experts, and the expert shards' partial
# rows are summed over the model axis.  Nothing is replicated that the
# specs shard.
def _expert_shard(mesh, E: int):
    """(first expert, experts) of this device's shard of the E axis."""
    names = mesh.mesh_dim_names
    if "model" not in names:
        return 0, E
    n = mesh.size(names.index("model"))
    if E % n:
        raise ValueError(f"{E} experts do not divide the model axis ({n})")
    return mesh.get_local_rank("model") * (E // n), E // n


def _region_placements(mesh, token_major_out: bool):
    from torch.distributed.tensor import Partial
    tok = placements(mesh, (("pod", "data"), None))
    tok1 = placements(mesh, (("pod", "data"),))
    exp = placements(mesh, ("model", None, None))
    if token_major_out:       # token rows, partial over the experts
        out = [Partial() if a == "model" else pl
               for a, pl in zip(mesh.mesh_dim_names, tok)]
    else:                     # expert rows, partial over the tokens
        out = [Partial() if a in ("pod", "data") else pl
               for a, pl in zip(mesh.mesh_dim_names, exp)]
    return tok, tok1, exp, out


def _dispatch_on_mesh(upd, e_safe, p_safe, E: int, cap: int):
    from torch.distributed.tensor.experimental import local_map
    mesh = current_mesh()
    e0, n_e = _expert_shard(mesh, E)
    tok, tok1, _, out = _region_placements(mesh, token_major_out=False)

    def local(u, e, p):
        e = e - e0
        ok = (e >= 0) & (e < n_e)
        disp = torch.zeros((n_e, cap, u.shape[-1]), dtype=u.dtype,
                           device=u.device)
        disp.index_put_((torch.where(ok, e, 0), p),
                        torch.where(ok[:, None], u,
                                    torch.zeros((), dtype=u.dtype)),
                        accumulate=True)
        return disp
    ins = (tok, tok1, tok1)
    return local_map(local, out_placements=out, in_placements=ins,
                     in_grad_placements=grad_placements(ins, out),
                     device_mesh=mesh,
                     redistribute_inputs=True)(upd, e_safe, p_safe)


def _combine_on_mesh(y, e_safe, p_safe):
    from torch.distributed.tensor.experimental import local_map
    mesh = current_mesh()
    e0, n_e = _expert_shard(mesh, y.shape[0])
    _, tok1, exp, out = _region_placements(mesh, token_major_out=True)

    def local(yl, e, p):
        e = e - e0
        ok = (e >= 0) & (e < n_e)
        rows = yl[torch.where(ok, e, 0), p]
        return torch.where(ok[:, None], rows,
                           torch.zeros((), dtype=rows.dtype))
    ins = (exp, tok1, tok1)
    return local_map(local, out_placements=out, in_placements=ins,
                     in_grad_placements=grad_placements(ins, out),
                     device_mesh=mesh,
                     redistribute_inputs=True)(y, e_safe, p_safe)


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
