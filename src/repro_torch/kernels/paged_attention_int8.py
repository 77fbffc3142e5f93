"""Int8 decode attention (the W8/KV8 path): the CUDA kernel
``csrc/paged_decode_int8.cu`` and its plain PyTorch versions.

Port of ``repro/kernels/paged_attention_int8.py``.  The KV cache holds
int8 values with one f32 scale per (token, kv head), dequantized inside
the kernel.  One kernel serves two layouts of the cache without a copy
(see the source for the addressing):

* ``paged_decode_attention_int8`` — the Pallas kernel's signature: int8
  head-blocks ``[N, BT, hd]`` with scales ``[N, BT]``, picked by a
  group-base table;
* ``dense_decode_attention_int8`` — one layer of the W8/KV8 decode
  step's dense cache ``[B, S, KV, hd]`` with scales ``[B, S, KV]``
  (``launch/steps.py``'s ``_decode_attend_dense_q``).

CPU tensors run the plain versions (dequantize, then attend in f32);
CUDA tensors launch the kernel, which runs or raises.  A row with no
cached token (``seq_len`` 0) comes out 0, as in the Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import decode_splits
from repro_torch.kernels.build import CudaKernel, check_operands, dtype_code
from repro_torch.kernels.ops import runs_kernel
from repro_torch.paging import dense_decode_attention
from repro_torch.paging import fused_paged_decode_attention as _paged_plain
from repro_torch.paging import resolve_physical_blocks

DECODE_INT8_KERNEL = CudaKernel(
    "repro_decode_int8", "paged_decode_int8.cu", "pppppppppiiiiiilllliifii",
    replaces="src/repro/kernels/paged_attention_int8.py:69")
MAX_GROUP = 8           # query heads per kv head the kernel keeps resident
HEAD_DIMS = (64, 128)


def paged_layout(bt: int, max_blocks: int):
    """The kernel's addressing of a paged pool ``[N, bt, hd]`` (token t
    of a row in block ``phys[b, h, t // bt]``): ``(max_blocks, bt,
    max_tok, blk_rows, row_rows, head_rows, tok_rows)`` as the source
    defines them."""
    return (max_blocks, bt, max_blocks * bt, bt, 0, 0, 1)


def dense_layout(S: int, KV: int):
    """The kernel's addressing of one dense cache layer ``[B, S, KV,
    hd]`` (no table, one block of S tokens: token t of row b, kv head h
    is row ``(b*S + t)*KV + h``), in ``paged_layout``'s order."""
    return (1, S, S, 0, S * KV, 1, KV)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _empty_rows_zero(out, seq_lens):
    """Rows that attend over no token are 0 (the Pallas kernel's
    ``acc / max(l, 1e-30)`` with nothing accumulated)."""
    return torch.where(seq_lens.reshape(-1, 1, 1) > 0, out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def dense_int8_plain(q, ckq, cvq, sk, sv, lens):
    """Plain ``dense_decode_attention_int8``: dequantize the layer, then
    ``paging.dense_decode_attention``."""
    out = dense_decode_attention(q, ckq.float() * sk[..., None],
                                 cvq.float() * sv[..., None], lens)
    return _empty_rows_zero(out, lens)


def paged_int8_plain(q, pool_k, pool_v, pool_sk, pool_sv, phys, seq_lens):
    """Plain ``fused_paged_decode_attention_int8``: dequantize the blocks
    ``phys`` picks into a compact f32 pool, then run the paged decode
    attention (``paging.fused_paged_decode_attention``) on it in f32."""
    B, n_kv, max_blocks = phys.shape
    idx = phys.long().reshape(-1)
    k = pool_k[idx].float() * pool_sk[idx][..., None]
    v = pool_v[idx].float() * pool_sv[idx][..., None]
    compact = torch.arange(idx.numel(), dtype=torch.int32,
                           device=q.device).reshape(B, n_kv, max_blocks)
    out = _paged_plain(q.float(), k, v, compact, seq_lens).to(q.dtype)
    return _empty_rows_zero(out, seq_lens)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(name, q, k, v, sk, sv, seq_lens, n_kv):
    B, H, hd = q.shape
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{name}: the cache must be int8")
    if sk.dtype != torch.float32 or sv.dtype != torch.float32:
        raise TypeError(f"{name}: the scales must be float32")
    if seq_lens.dtype != torch.int32 or seq_lens.shape != (B,):
        raise TypeError(f"{name}: seq_lens must be int32 [B]")
    if k.shape != v.shape or sk.shape != sv.shape \
            or sk.shape != k.shape[:-1] or k.shape[-1] != hd:
        raise ValueError(f"{name}: cache {tuple(k.shape)} / scales "
                         f"{tuple(sk.shape)} do not match q {tuple(q.shape)}")
    if H % n_kv or H // n_kv > MAX_GROUP or hd not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head_dim in {HEAD_DIMS} "
                         f"and at most {MAX_GROUP} query heads per kv head "
                         f"(got H={H}, n_kv={n_kv}, hd={hd})")
    check_operands(name, q.device, q=q, k=k, v=v)
    check_operands(name, q.device, align=4, sk=sk, sv=sv, seq_lens=seq_lens)


def _launch(q, k, v, sk, sv, table, seq_lens, n_kv, layout, table_bt):
    """Plan the splits from shapes (``layout[2]`` is max_tok), allocate
    the output and the workspace, launch."""
    B, H, hd = q.shape
    plan, ws = decode_splits.prepare(q, n_kv, layout[2], table_bt)
    out = torch.empty_like(q)
    DECODE_INT8_KERNEL(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sk.data_ptr(),
        sv.data_ptr(), None if table is None else table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, H, n_kv, *layout, hd,
        dtype_code(q.dtype), 1.0 / math.sqrt(hd), *plan, device=q.device)
    return out


def fused_paged_decode_attention_int8(q, pool_k, pool_v, pool_sk, pool_sv,
                                      phys, seq_lens):
    """Decode attention over int8 head-blocks picked by pre-resolved
    physical ids.

    q: [B, H, hd] (post-RoPE); pool_k/v: [N, BT, hd] int8; pool_sk/sv:
    [N, BT] f32 per-token scales; phys: [B, n_kv, max_blocks] int32
    (invalid entries point at a valid block, e.g. 0, and are masked via
    seq_lens); seq_lens: [B] int32.  Returns [B, H, hd]."""
    if not runs_kernel("paged_decode_attention_int8", q, pool_k, pool_v,
                       pool_sk, pool_sv, phys, seq_lens):
        return paged_int8_plain(q, pool_k, pool_v, pool_sk, pool_sv, phys,
                                seq_lens)
    B, H, hd = q.shape
    n_kv, max_blocks = phys.shape[1], phys.shape[2]
    if pool_k.dim() != 3 or phys.shape[0] != B:
        raise ValueError(f"pool {tuple(pool_k.shape)} / phys "
                         f"{tuple(phys.shape)} do not match q")
    if phys.dtype != torch.int32:
        raise TypeError("phys must be int32")
    _check("paged_decode_attention_int8", q, pool_k, pool_v, pool_sk,
           pool_sv, seq_lens, n_kv)
    check_operands("paged_decode_attention_int8", q.device, align=4,
                   phys=phys)
    bt = pool_k.shape[1]
    return _launch(q, pool_k, pool_v, pool_sk, pool_sv, phys, seq_lens, n_kv,
                   paged_layout(bt, max_blocks), table_bt=bt)


def paged_decode_attention_int8(q, pool_k, pool_v, pool_sk, pool_sv, table,
                                seq_lens, layer, *, n_kv):
    """Decode attention over an int8 paged pool (the Pallas kernel's
    signature).

    q: [B, H, hd] (post-RoPE); pool_k/v: [N, BT, hd] int8;
    pool_sk/sv: [N, BT] f32 per-token scales; table: [B, max_blocks]
    int32 group bases (−1 padded); seq_lens: [B]."""
    phys = resolve_physical_blocks(table, layer, n_kv)
    return fused_paged_decode_attention_int8(q, pool_k, pool_v, pool_sk,
                                             pool_sv, phys, seq_lens)


def dense_decode_attention_int8(q, ckq, cvq, sk, sv, lens):
    """Decode attention over one layer of a dense int8 cache, read in
    place.

    q: [B, H, hd]; ckq/cvq: [B, S, KV, hd] int8; sk/sv: [B, S, KV] f32
    per-token scales; lens: [B] int32 (including the current token;
    tokens at t >= lens are masked, and past S never read).
    Returns [B, H, hd]."""
    if not runs_kernel("dense_decode_attention_int8", q, ckq, cvq, sk, sv,
                       lens):
        return dense_int8_plain(q, ckq, cvq, sk, sv, lens)
    B, H, hd = q.shape
    if ckq.dim() != 4 or ckq.shape[0] != B:
        raise ValueError(f"cache {tuple(ckq.shape)} does not match q "
                         f"{tuple(q.shape)}")
    S, KV = ckq.shape[1], ckq.shape[2]
    _check("dense_decode_attention_int8", q, ckq, cvq, sk, sv, lens, KV)
    return _launch(q, ckq, cvq, sk, sv, None, lens, KV, dense_layout(S, KV),
                   table_bt=None)
