"""Device-side ops on the unified head-wise KV pool (port of
``repro/serving/cache_ops.py``).

Physical head-block id for (token-block base b, layer l, kv head h) of a
model with KV kv-heads: ``b + l*KV + h`` (groups are contiguous — see
serving/kvcache.py).

The attention ops here are the kernel wrappers: CUDA tensors launch the
Hopper kernels, CPU tensors run their plain versions.  Unlike the JAX
package the KV writes and the block-group copy update the arena in
place: the steps never re-read a pre-step pool, so nothing needs the
old contents, and the pool's ``k``/``v`` stay views onto its arena
buffers (``UnifiedKVPool._k_buf``/``_v_buf``).  So does ``write_window``,
the sliding-window decode's ring-buffer write.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.flash_prefill import (
    fused_paged_flash_prefill as fused_paged_chunk_attention)
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import (fused_paged_decode_attention,
                                                 paged_decode_attention)
from repro_torch.paging import resolve_physical_blocks

__all__ = ["TokenSlots", "plan_slots", "token_slots", "write_slots", "write_tokens",
           "copy_block_groups", "resolve_physical_blocks", "fused_paged_decode_attention",
           "paged_decode_attention", "fused_paged_chunk_attention",
           "paged_chunk_attention", "flash_prefill",
           "windowed_decode_attention", "write_window"]


def copy_block_groups(pool_k, pool_v, src_bases, dst_bases, n_kv, n_layers,
                      src_k=None, src_v=None):
    """Device-side page copy between block groups — one gather and one
    scatter over every (layer, kv-head) page of each group, in place.

    Logical group bases are resolved to physical head-block ids through
    ``paging.resolve_physical_blocks`` — the SAME resolution every
    kernel uses, so the copy can never disagree with the pool layout.
    Source and destination index lists are elementwise aligned, making
    this an exact page copy.  Powers copy-on-write divergence of a
    shared prefix block (same pool: ``src_k/src_v`` default to the
    destination tensors) and cross-pool KV migration (pass the source
    pool's tensors).  The source pages are gathered into a new tensor
    before the scatter writes, so a copy within one tensor reads no
    page it has already overwritten.

    pool_k/pool_v: destination arena [N, BT, hd], written in place
    src_bases/dst_bases: group base per token-block (host lists)
    Returns (pool_k, pool_v).
    """
    if src_k is None:
        src_k, src_v = pool_k, pool_v

    def phys(bases, device):
        t = torch.as_tensor(list(bases), dtype=torch.int32,
                            device=device)[None, :]
        return torch.cat([resolve_physical_blocks(t, li, n_kv)
                          for li in range(n_layers)], dim=1).reshape(-1).long()
    sp = phys(src_bases, src_k.device)
    dp = phys(dst_bases, pool_k.device)
    for dst, src in ((pool_k, src_k), (pool_v, src_v)):
        dst.index_copy_(0, dp, src.index_select(0, sp).to(
            device=dst.device, dtype=dst.dtype))
    return pool_k, pool_v


class TokenSlots(NamedTuple):
    """Where the new tokens of one step land in the pool: a plan of fixed
    length (every one of the step's ``B*S`` new tokens has an entry),
    made once per step on the host and reused by every layer.

    src: [n] flat index of the written token into the step's ``B*S``
    base: [n] group base of its block
    off: [n] position inside the block
    live: [] bool, whether the step keeps any write
    A token the JAX package's scatter drops (``mode="drop"``: a position
    past the table, or a block whose base is −1) is planned as a copy of
    the step's first kept write: the same place and the same value, so
    it changes nothing.  A step that keeps no write rewrites one arena
    entry (group base 0, position 0) with its own contents.  The length
    depends on shapes only, so a captured step replays at any table
    (``serving/graphs.py``).
    """
    src: torch.Tensor
    base: torch.Tensor
    off: torch.Tensor
    live: torch.Tensor


def plan_slots(table, start_pos, n_new: int,
               block_tokens: int) -> Dict[str, np.ndarray]:
    """The host half of ``token_slots``: the plan of ``n_new`` tokens per
    row starting at ``start_pos`` [B] against group-base ``table`` [B,
    max_blocks], as numpy arrays: ``src``, ``base``, ``off`` [B*n_new]
    int64 and ``live`` [] bool."""
    table = np.asarray(table, np.int64)
    start = np.asarray(start_pos, np.int64)
    B, W = table.shape
    pos = start[:, None] + np.arange(n_new)[None, :]          # [B, S]
    blk = pos // block_tokens
    base = np.take_along_axis(table, np.minimum(blk, W - 1), axis=1)
    keep = ((blk < W) & (base >= 0)).reshape(-1)
    kept = np.flatnonzero(keep)
    if kept.size == 0:
        zero = np.zeros(B * n_new, np.int64)
        return dict(src=zero, base=zero, off=zero, live=np.array(False))
    src = np.where(keep, np.arange(B * n_new), kept[0])
    return dict(src=src, base=base.reshape(-1)[src],
                off=(pos % block_tokens).reshape(-1)[src],
                live=np.array(True))


def token_slots(table, start_pos, n_new: int, block_tokens: int,
                device) -> TokenSlots:
    """Plan the writes of ``n_new`` tokens per row starting at
    ``start_pos`` [B] against group-base ``table`` [B, max_blocks]
    (host arrays or tensors) and move the plan to ``device``."""
    plan = plan_slots(np.asarray(torch.as_tensor(table).cpu()),
                      np.asarray(torch.as_tensor(start_pos).cpu()), n_new,
                      block_tokens)
    return TokenSlots(*(torch.from_numpy(plan[k]).to(device)
                        for k in TokenSlots._fields))


def write_slots(pool_k, pool_v, k_new, v_new, slots: TokenSlots, layer: int,
                n_kv: int) -> None:
    """Scatter new KV ``k_new/v_new`` [B, S, KV, hd] of attention layer
    ``layer`` into the arena, in place, at the planned ``slots``.  Where
    the plan keeps no write, the one planned entry is written with the
    contents it had (gathered before the scatter).  No host data, no
    data-dependent shape: a CUDA graph captures it."""
    hd = k_new.shape[-1]
    heads = torch.arange(n_kv, device=slots.base.device)
    phys = slots.base[:, None] + layer * n_kv + heads[None, :]   # [n, KV]
    off = slots.off[:, None].expand_as(phys)
    for pool, new in ((pool_k, k_new), (pool_v, v_new)):
        val = new.reshape(-1, n_kv, hd)[slots.src].to(pool.dtype)
        val = torch.where(slots.live, val, pool[phys[:1], off[:1]])
        pool[phys, off] = val


def write_tokens(pool_k, pool_v, k_new, v_new, table, start_pos, layer, n_kv):
    """Scatter new KV into the pool (in place; returns the pool too).

    pool_k/v: [N, BT, hd]
    k_new/v_new: [B, S, KV, hd] — S new tokens starting at start_pos[b]
    table: [B, max_blocks] int32 group bases (−1 padded)
    start_pos: [B] int32 — position of the first new token
    """
    slots = token_slots(table, start_pos, k_new.shape[1], pool_k.shape[1],
                        pool_k.device)
    write_slots(pool_k, pool_v, k_new, v_new, slots, layer, n_kv)
    return pool_k, pool_v


def paged_chunk_attention(q, pool_k, pool_v, table, q_offset, layer, n_kv):
    """Chunked-prefill attention, single-model view: resolves the
    group-base ``table`` and runs the fused chunk attention.

    q: [B, C, H, hd] (post-RoPE, absolute positions q_offset+i)
    pool_k/v: [N, BT, hd]; table: [B, max_blocks]; q_offset: [B]
    Returns [B, C, H, hd].
    """
    phys = resolve_physical_blocks(table, layer, n_kv)
    return fused_paged_chunk_attention(q, pool_k, pool_v, phys, q_offset)


def windowed_decode_attention(q, win_k, win_v, seq_lens, window):
    """Decode attention over a ring-buffer sliding-window cache.

    q: [B,H,hd]; win_k/v: [B, KV, W, hd] ring buffers; seq_lens: [B]
    (length including current token).  Slot for position p is p % W.
    Operands meet in the wider type, scores and softmax in float32,
    probabilities cast to q's dtype before P·V, as the reference (plain
    PyTorch: the reference's is XLA, no Pallas kernel).
    """
    B, H, hd = q.shape
    KV, W = win_k.shape[1], win_k.shape[2]
    group = H // KV
    scale = 1.0 / math.sqrt(hd)
    dt = torch.promote_types(q.dtype, win_k.dtype)
    qh = q.reshape(B, KV, group, hd).to(dt)
    scores = torch.einsum("bkgd,bkwd->bkgw", qh, win_k.to(dt)).float() * scale
    # valid slots: positions in [seq_len - min(seq_len, W), seq_len)
    slot = torch.arange(W, device=q.device)[None, :]
    cur = seq_lens.reshape(B, 1).long()
    # position stored in slot s: the largest p < cur with p % W == s
    p_in_slot = cur - 1 - torch.remainder(cur - 1 - slot, W)
    valid = (p_in_slot >= 0) & (p_in_slot >= cur - W)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(q.dtype, win_v.dtype)
    return torch.einsum("bkgw,bkwd->bkgd", probs.to(dt),
                        win_v.to(dt)).reshape(B, H, hd)


def write_window(win_k, win_v, k_new, v_new, pos):
    """Write one token's KV into the ring buffer at slot pos % W, in
    place (the reference returns updated copies).

    win_k/v: [B,KV,W,hd]; k_new/v_new: [B,KV,hd]; pos: [B].
    Returns (win_k, win_v), the tensors it was given."""
    W = win_k.shape[2]
    slot = torch.remainder(pos.long(), W)
    b_idx = torch.arange(win_k.shape[0], device=win_k.device)
    win_k[b_idx, :, slot] = k_new.to(win_k.dtype)
    win_v[b_idx, :, slot] = v_new.to(win_v.dtype)
    return win_k, win_v
