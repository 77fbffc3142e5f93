"""Paged decode attention: the CUDA kernel ``csrc/paged_decode.cu`` and
its plain PyTorch version.

Port of ``repro/kernels/paged_attention.py``.  The plain version is the
JAX package's oracle, ``paging.fused_paged_decode_attention``; it runs
for CPU tensors (the tests and the CPU engine) and is the reference the
kernel is held to on the card.  For CUDA tensors the wrapper launches
the split-KV kernel (each row's tokens spread over CTAs and merged; the
split is planned from shapes by ``decode_splits``; see the source for
the design and what bounds it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import BLOCK_TOKENS
from repro_torch.kernels import decode_splits
from repro_torch.kernels.build import CudaKernel, check_operands, dtype_code
from repro_torch.kernels.ops import runs_kernel
from repro_torch.paging import fused_paged_decode_attention as decode_plain
from repro_torch.paging import resolve_physical_blocks

DECODE_KERNEL = CudaKernel(
    "repro_paged_decode", "paged_decode.cu", "pppppppiiiiiifii",
    replaces="src/repro/kernels/paged_attention.py:79")
MAX_GROUP = decode_splits.MAX_GROUP   # query heads per kv head (16)
HEAD_DIMS = (64, 96, 128)


def fused_paged_decode_attention(q, pool_k, pool_v, phys, seq_lens):
    """Multi-sequence decode attention over pre-resolved physical
    blocks; rows may belong to different colocated models.

    q: [B, H, hd] (one post-RoPE query token per row)
    pool_k/v: [N, BT, hd] head-block arena
    phys: [B, n_kv, max_blocks] int32 physical ids (invalid entries
        point at a valid block, e.g. 0, and are masked via seq_lens)
    seq_lens: [B] int32 (length including the current token; a row of
        length 0 comes out 0 from the kernel, as from the Pallas kernel)
    Returns [B, H, hd].
    """
    if not runs_kernel("fused_paged_decode_attention", q, pool_k, pool_v,
                       phys, seq_lens):
        return decode_plain(q, pool_k, pool_v, phys, seq_lens)
    B, H, hd = q.shape
    n_kv, max_blocks = phys.shape[1], phys.shape[2]
    if (pool_k.shape != pool_v.shape or pool_k.dim() != 3
            or pool_k.shape[1:] != (BLOCK_TOKENS, hd)):
        raise ValueError(f"pool {tuple(pool_k.shape)} does not match "
                         f"[N, {BLOCK_TOKENS}, {hd}]")
    if phys.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("phys / seq_lens rows do not match q")
    if phys.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("phys and seq_lens must be int32")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError("q and the pool must share one dtype")
    if H % n_kv or H // n_kv > MAX_GROUP or hd not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS} and "
                         f"at most {MAX_GROUP} query heads per kv head "
                         f"(got H={H}, n_kv={n_kv}, hd={hd})")
    check_operands("fused_paged_decode_attention", q.device, q=q,
                   pool_k=pool_k, pool_v=pool_v, phys=phys,
                   seq_lens=seq_lens)
    plan, ws = decode_splits.prepare(q, n_kv, max_blocks * BLOCK_TOKENS,
                                     BLOCK_TOKENS)
    out = torch.empty_like(q)
    DECODE_KERNEL(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                  phys.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(), B, H, n_kv,
                  max_blocks, hd, dtype_code(q.dtype), 1.0 / math.sqrt(hd),
                  *plan, device=q.device)
    return out


def paged_decode_attention(q, pool_k, pool_v, table, seq_lens, layer, n_kv):
    """Decode attention against the paged pool (single-model view):
    resolves the group-base ``table`` [B, max_blocks] (−1 padded) of
    attention layer ``layer`` and runs the fused kernel."""
    phys = resolve_physical_blocks(table, layer, n_kv)
    return fused_paged_decode_attention(q, pool_k, pool_v, phys, seq_lens)
