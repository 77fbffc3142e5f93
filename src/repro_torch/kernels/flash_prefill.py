"""Prefill attention: two CUDA kernels and their plain PyTorch versions.

Port of ``repro/kernels/flash_prefill.py``:

* ``fused_paged_flash_prefill`` — chunked-prefill attention over the
  head-block pool (``csrc/paged_prefill.cu``); plain version
  ``paged_prefill_plain``, the JAX package's oracle
  ``cache_ops.fused_paged_chunk_attention``.
* ``flash_prefill`` — dense causal attention for whole-prompt prefill
  (``csrc/flash_prefill.cu``); plain version ``models.layers
  .causal_attention``.

CPU tensors run the plain versions; CUDA tensors launch the kernels.
``flash_prefill`` is differentiable on both: on CUDA tensors the kernel
computes the forward and the backward is ``flash_prefill_vjp``, the VJP
of the plain version recomputed from the saved inputs (training,
``models/transformer.loss_fn``).  Where no input wants a gradient (the
serving path) the kernel is launched without the autograd node, which
costs the host a call's worth of time (PERF.md §6).  The paged kernel
serves only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import BLOCK_TOKENS
from repro_torch.kernels.build import CudaKernel, check_operands, dtype_code
from repro_torch.kernels.ops import runs_kernel
from repro_torch.models.layers import causal_attention as flash_prefill_plain

PAGED_KERNEL = CudaKernel(
    "repro_paged_prefill", "paged_prefill.cu", "ppppppiiiiiiif",
    replaces="src/repro/kernels/flash_prefill.py:183")
FLASH_KERNEL = CudaKernel(
    "repro_flash_prefill", "flash_prefill.cu", "ppppiiiiiiif",
    replaces="src/repro/kernels/flash_prefill.py:82")
HEAD_DIMS = (64, 96, 128)


def _check_common(name: str, q, *others) -> None:
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    for t in others:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: operands must share q's dtype {q.dtype}")


# ---------------------------------------------------------------------------
# fused paged chunk prefill
# ---------------------------------------------------------------------------
def paged_prefill_plain(q, pool_k, pool_v, phys, q_offset):
    """Plain multi-sequence chunk attention over pre-resolved blocks.

    q: [B, C, H, hd] (post-RoPE, absolute positions q_offset+i; rows
        may belong to different models)
    pool_k/v: [N, BT, hd]
    phys: [B, n_kv, max_blocks] int32 physical head-block ids
    q_offset: [B] int32 absolute position of each row's first query
    Returns [B, C, H, hd].
    """
    B, C, H, hd = q.shape
    BT = pool_k.shape[1]
    n_kv, max_blocks = phys.shape[1], phys.shape[2]
    group = H // n_kv
    scale = 1.0 / math.sqrt(hd)

    idx = phys.long()
    k = pool_k[idx].reshape(B, n_kv, max_blocks * BT, hd)
    v = pool_v[idx].reshape(B, n_kv, max_blocks * BT, hd)

    qh = q.reshape(B, C, n_kv, group, hd)
    scores = torch.einsum("bckgd,bktd->bkgct", qh, k).float() * scale
    t_pos = torch.arange(max_blocks * BT, device=q.device)
    q_pos = q_offset[:, None] + torch.arange(C, device=q.device)  # [B, C]
    mask = t_pos[None, None, None, None, :] <= q_pos[:, None, None, :, None]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgct,bktd->bckgd", probs, v)
    return out.reshape(B, C, H, hd)


def fused_paged_flash_prefill(q, pool_k, pool_v, phys, q_offset):
    """Chunked-prefill attention: C query tokens per row attend causally
    to the pool (earlier chunks plus this chunk's already-written KV);
    arguments as ``paged_prefill_plain``.  Invalid phys entries must
    point at a valid block (e.g. 0); the causal mask hides them."""
    if not runs_kernel("fused_paged_flash_prefill", q, pool_k, pool_v, phys,
                       q_offset):
        return paged_prefill_plain(q, pool_k, pool_v, phys, q_offset)
    B, C, H, hd = q.shape
    n_kv, max_blocks = phys.shape[1], phys.shape[2]
    _check_common("fused_paged_flash_prefill", q, pool_k, pool_v)
    if (pool_k.shape != pool_v.shape or pool_k.dim() != 3
            or pool_k.shape[1:] != (BLOCK_TOKENS, hd)):
        raise ValueError(f"pool {tuple(pool_k.shape)} does not match "
                         f"[N, {BLOCK_TOKENS}, {hd}]")
    if phys.shape[0] != B or q_offset.shape != (B,) or H % n_kv:
        raise ValueError("phys / q_offset do not match q")
    if phys.dtype != torch.int32 or q_offset.dtype != torch.int32:
        raise TypeError("phys and q_offset must be int32")
    check_operands("fused_paged_flash_prefill", q.device, q=q, pool_k=pool_k,
                   pool_v=pool_v, phys=phys, q_offset=q_offset)
    out = torch.empty_like(q)
    PAGED_KERNEL(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                 phys.data_ptr(), q_offset.data_ptr(), out.data_ptr(),
                 B, C, H, n_kv, max_blocks, hd, dtype_code(q.dtype),
                 1.0 / math.sqrt(hd), device=q.device)
    return out


# ---------------------------------------------------------------------------
# dense causal flash prefill
# ---------------------------------------------------------------------------
def flash_prefill(q, k, v, *, window: Optional[int] = None):
    """Causal attention.  q: [B,S,H,hd]; k/v: [B,S,KV,hd]; ``window``:
    optional sliding window.  Any S (the kernel masks the ragged
    edge).  Differentiable on both devices: on CUDA tensors the kernel
    computes the forward and ``flash_prefill_vjp`` the backward (through
    ``_FlashPrefill`` only where an input wants a gradient)."""
    if not runs_kernel("flash_prefill", q, k, v):
        return flash_prefill_plain(q, k, v, window=window)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    _check_common("flash_prefill", q, k, v)
    if k.shape != (B, S, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    check_operands("flash_prefill", q.device, q=q, k=k, v=v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashPrefill.apply(q, k, v, window)
    return _launch_flash(q, k, v, window)


def _launch_flash(q, k, v, window):
    out = torch.empty_like(q)
    B, S, H, hd = q.shape
    FLASH_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], hd, window or 0, dtype_code(q.dtype),
                 1.0 / math.sqrt(hd), device=q.device)
    return out


def flash_prefill_vjp(q, k, v, grad_out, *, window: Optional[int] = None):
    """The backward of ``flash_prefill``: the vector-Jacobian product of
    its plain version at (q, k, v) with ``grad_out``, recomputed from the
    inputs (the JAX package differentiates the same XLA attention; it
    has no backward kernel).  Returns (dq, dk, dv)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_prefill_plain(*ins, window=window)
        return torch.autograd.grad(out, ins, grad_out)


class _FlashPrefill(torch.autograd.Function):
    """Kernel 3 as an autograd node: the forward launches the kernel,
    the backward is ``flash_prefill_vjp`` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out = _launch_flash(q, k, v, window)
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*flash_prefill_vjp(q, k, v, grad_out, window=ctx.window),
                None)
