"""Device-side ops on the unified head-wise KV pool (port of
``repro/serving/cache_ops.py``).

Physical head-block id for (token-block base b, layer l, kv head h) of a
model with KV kv-heads: ``b + l*KV + h`` (groups are contiguous — see
serving/kvcache.py).

The attention ops here are the kernel wrappers: CUDA tensors launch the
Hopper kernels, CPU tensors run their plain versions.  Unlike the JAX
package the KV writes update the arena in place: the steps never
re-read a pre-step pool, so nothing needs the old contents.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.flash_prefill import (
    fused_paged_flash_prefill as fused_paged_chunk_attention)
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import (fused_paged_decode_attention,
                                                 paged_decode_attention)
from repro_torch.paging import resolve_physical_blocks

__all__ = ["TokenSlots", "token_slots", "write_slots", "write_tokens",
           "resolve_physical_blocks", "fused_paged_decode_attention",
           "paged_decode_attention", "fused_paged_chunk_attention",
           "paged_chunk_attention", "flash_prefill"]


class TokenSlots(NamedTuple):
    """Where the new tokens of one step land in the pool, computed once
    per step on the host and reused by every layer.

    src: [n] flat index of the token into the step's ``B*S`` new tokens
    base: [n] group base of the token's block
    off: [n] position inside the block
    Only tokens that land in the table are listed: positions past the
    table, or in a block whose base is −1, are dropped — what the JAX
    package's scatter does with ``mode="drop"``.
    """
    src: torch.Tensor
    base: torch.Tensor
    off: torch.Tensor


def token_slots(table, start_pos, n_new: int, block_tokens: int,
                device) -> TokenSlots:
    """Plan the writes of ``n_new`` tokens per row starting at
    ``start_pos`` [B] against group-base ``table`` [B, max_blocks]
    (host arrays or tensors)."""
    table = np.asarray(torch.as_tensor(table).cpu(), np.int64)
    start = np.asarray(torch.as_tensor(start_pos).cpu(), np.int64)
    B, W = table.shape
    pos = start[:, None] + np.arange(n_new)[None, :]          # [B, S]
    blk = pos // block_tokens
    in_table = blk < W
    base = np.take_along_axis(table, np.minimum(blk, W - 1), axis=1)
    keep = (in_table & (base >= 0)).reshape(-1)
    src = np.nonzero(keep)[0]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TokenSlots(dev(src), dev(base.reshape(-1)[src]),
                      dev((pos % block_tokens).reshape(-1)[src]))


def write_slots(pool_k, pool_v, k_new, v_new, slots: TokenSlots, layer: int,
                n_kv: int) -> None:
    """Scatter new KV ``k_new/v_new`` [B, S, KV, hd] of attention layer
    ``layer`` into the arena, in place, at the planned ``slots``."""
    hd = k_new.shape[-1]
    heads = torch.arange(n_kv, device=slots.base.device)
    phys = slots.base[:, None] + layer * n_kv + heads[None, :]   # [n, KV]
    off = slots.off[:, None].expand_as(phys)
    pool_k[phys, off] = k_new.reshape(-1, n_kv, hd)[slots.src].to(pool_k.dtype)
    pool_v[phys, off] = v_new.reshape(-1, n_kv, hd)[slots.src].to(pool_v.dtype)


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
