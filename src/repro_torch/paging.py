"""Shared paged-KV index arithmetic and the plain decode attentions
(port of ``repro/paging.py``).

Physical head-block id for (token-block base b, layer l, kv head h) of
a model with KV kv-heads: ``b + l*KV + h`` (groups are contiguous —
see serving/kvcache.py).  The plain decode attention here is the CPU
path and the reference of the CUDA decode kernel; its single-model
view (a table instead of resolved ids) is
``kernels/paged_attention.paged_decode_attention``.  The dense-cache
decode attention is the serve steps' float decode (``launch/steps.py``)
and, over dequantized int8, the plain version of the int8 decode kernel.
"""
from __future__ import annotations

import math

import torch


def resolve_physical_blocks(table, layer, n_kv):
    """Resolve a group-base block table to physical head-block ids.

    table: [..., max_blocks] int32 group bases (−1 padded), any number
    of leading batch dims.
    Returns [..., n_kv, max_blocks] int32 physical ids (invalid → 0;
    the caller masks those positions via seq_lens / query positions).
    """
    heads = torch.arange(n_kv, dtype=torch.int32,
                         device=table.device)[:, None]        # [n_kv, 1]
    phys = table.clamp(min=0)[..., None, :] + layer * n_kv + heads
    return torch.where(table[..., None, :] >= 0, phys, 0).to(torch.int32)


def fused_paged_decode_attention(q, pool_k, pool_v, phys, seq_lens):
    """Multi-sequence decode attention over pre-resolved physical
    blocks (plain version).

    q: [B, H, hd] — one query token per row (post-RoPE)
    pool_k/v: [N, BT, hd]
    phys: [B, n_kv, max_blocks] int32 physical head-block ids
    seq_lens: [B] (length INCLUDING the current token)
    Returns [B, H, hd].
    """
    B, H, hd = q.shape
    BT = pool_k.shape[1]
    n_kv, max_blocks = phys.shape[1], phys.shape[2]
    group = H // n_kv
    scale = 1.0 / math.sqrt(hd)

    idx = phys.long()
    k = pool_k[idx].reshape(B, n_kv, max_blocks * BT, hd)
    v = pool_v[idx].reshape(B, n_kv, max_blocks * BT, hd)

    qh = q.reshape(B, n_kv, group, hd)
    scores = torch.einsum("bkgd,bktd->bkgt", qh, k).float() * scale
    t_pos = torch.arange(max_blocks * BT, device=q.device)
    mask = t_pos[None, None, None, :] < seq_lens[:, None, None, None]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v)
    return out.reshape(B, H, hd)



def dense_decode_attention(q, k, v, lens):
    """Decode attention over one dense cache layer, in f32 (plain).

    q: [B, H, hd]; k/v: [B, S, KV, hd] (any float type); lens: [B]
    (length including the current token).  Returns [B, H, hd] in q's
    type: the JAX package's ``launch/steps._decode_attend_dense`` (its
    chunking only bounds XLA's temporaries)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qh = q.float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh, k.float()) / math.sqrt(hd)
    t = torch.arange(S, device=q.device)
    s = torch.where(t < lens.reshape(B, 1, 1, 1), s, -1e30)
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(B, H, hd).to(q.dtype)
